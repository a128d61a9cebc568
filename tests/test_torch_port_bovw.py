"""The port's BoVW (histograms, BM25, the pipeline, the serving prologue,
the DAISY index and engine) against the JAX package's on the CPU.

Tolerances: histograms equal (counts); BM25 weights 1e-6; Davies-Bouldin
scores equal (the same numpy); a pipeline's transform across packages 1e-6
(the nearest codeword of each descriptor equal on these seeded inputs);
served distances 2e-4 (the engines round to 4 decimals), ids equal but
where two distances tie within it.
"""

import json
import threading
import urllib.request
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.bovw import pipeline as jpipe
from image_search_engine_tpu.config import Config as JaxConfig
from image_search_engine_tpu.config import CornerDescriptorKind as JaxKind
from image_search_engine_tpu.config import IndexType as JaxIndexType
from image_search_engine_tpu.config import Method as JaxMethod
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu.indexer import main as jax_indexer_main
from image_search_engine_tpu.ops import bm25 as jbm25
from image_search_engine_tpu.ops import histogram as jhist
from image_search_engine_tpu_torch import descriptors as pdesc
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.bovw import pipeline as ppipe
from image_search_engine_tpu_torch.config import Config, IndexType, Method
from image_search_engine_tpu_torch.ops import bm25 as pbm25
from image_search_engine_tpu_torch.ops import histogram as phist
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.serving import fused
from image_search_engine_tpu_torch.utils.imageio import load_image

TOL = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_histograms_match():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 7, (5, 30)).astype(np.int32)
    valid = rng.random((5, 30)) < 0.7
    want = jhist.batched_histograms(jnp.asarray(codes), jnp.asarray(valid), 7)
    got = phist.batched_histograms(torch.from_numpy(codes), torch.from_numpy(valid), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.repeat(np.arange(5), 30).astype(np.int32)
    for v in (None, valid.reshape(-1)):
        want = jhist.codes_to_histograms(jnp.asarray(codes.reshape(-1)), jnp.asarray(ids), 5, 7,
                                         valid=None if v is None else jnp.asarray(v))
        got = phist.codes_to_histograms(torch.from_numpy(codes.reshape(-1)),
                                        torch.from_numpy(ids), 5, 7,
                                        valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [{}, dict(use_train_avgdl=True), dict(apply_idf=True),
                                dict(k1=1.5, k2=0.5, b=0.3, use_train_avgdl=True)])
def test_bm25_matches(kw):
    rng = np.random.default_rng(1)
    hist = (rng.random((9, 12)) < 0.4) * rng.integers(1, 5, (9, 12))
    hist[3] = 0  # an image with no descriptor: its row stays 0
    hist = hist.astype(np.float32)
    np.testing.assert_allclose(pbm25.idf_fit(torch.from_numpy(hist)).numpy(),
                               np.asarray(jbm25.idf_fit(jnp.asarray(hist))), atol=1e-6)
    want = jbm25.OkapiBM25(**kw).fit(hist)
    got = pbm25.OkapiBM25(**kw).fit(hist)
    np.testing.assert_allclose(got.idf_, want.idf_, atol=1e-6)
    assert got.avgdl_ == pytest.approx(want.avgdl_, rel=1e-6)
    np.testing.assert_allclose(got.transform(hist), want.transform(hist), atol=1e-6)
    np.testing.assert_allclose(got.transform(hist[:1]), want.transform(hist[:1]), atol=1e-6)
    assert not got.transform(hist)[3].any()


def test_cluster_scores_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 5)).astype(np.float32)
    labels = rng.integers(0, 6, 300)
    assert ppipe.davies_bouldin_score(x, labels) == jpipe.davies_bouldin_score(x, labels)
    assert ppipe.sampled_cluster_score(x, labels, 50, 4) == jpipe.sampled_cluster_score(
        x, labels, 50, 4)
    with pytest.raises(ValueError):
        ppipe.davies_bouldin_score(x, np.zeros(300, int))
    best, scores = ppipe.sweep_num_clusters(x[:, None, :].repeat(2, 1), None, [3, 5],
                                            sample_size=100, repeats=2, device="cpu")
    assert best in (3, 5) and set(scores) == {3, 5}


def _descriptor_sets(seed, b=20, k=10, d=16):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((6, d))
    feats = centres[rng.integers(0, 6, (b, k))] + 0.3 * rng.standard_normal((b, k, d))
    return feats.astype(np.float32), rng.random((b, k)) < 0.8


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pipeline_npz_crosses_the_packages(tmp_path, direction):
    """A pipeline fitted and saved by one package loads in the other and
    transforms the same descriptor sets to the same histograms."""
    feats, valid = _descriptor_sets(3)
    path = tmp_path / "bovw_pipeline.npz"
    kw = dict(n_clusters=8, kmeans_niter=5, kmeans_nredo=1, descriptor_kind="daisy",
              descriptor_params={"daisy_step": 16, "resize_size": 64})
    if direction == "jax_to_port":
        src = jpipe.BoVWPipeline(**kw).fit(feats, valid)
        src.save(path)
        dst = ppipe.BoVWPipeline.load(path, device="cpu")
    else:
        src = ppipe.BoVWPipeline(**kw, device="cpu").fit(feats, valid)
        src.save(path)
        dst = jpipe.BoVWPipeline.load(path)
    np.testing.assert_array_equal(dst.kmeans.cluster_centers_, src.kmeans.cluster_centers_)
    assert (dst.descriptor_kind, dst.descriptor_params) == ("daisy", kw["descriptor_params"])
    assert (dst.n_clusters, dst.spherical, dst.use_train_avgdl) == (8, True, True)
    assert dst.bm25.avgdl_ == src.bm25.avgdl_
    q, qv = _descriptor_sets(4, b=6)
    np.testing.assert_allclose(dst.transform(q, qv), src.transform(q, qv), atol=1e-6)
    np.testing.assert_allclose(dst.transform(q, None), src.transform(q, None), atol=1e-6)


@pytest.mark.parametrize("descriptor", [
    pdesc.DaisyDescriptor(step=16, radius=16, device="cpu"),
    pdesc.CornerDescriptor("orb", 32, n_levels=2, device="cpu"),
    pdesc.CornerDescriptor("sift", 16, n_levels=1, device="cpu")], ids=["daisy", "orb", "sift"])
@pytest.mark.parametrize("normalize", [True, False])
def test_prologue_equals_the_staged_chain(descriptor, normalize):
    """The serving prologue (one device chain) against describe_batch ->
    pipeline.transform -> l2-normalize on the host: equal bit for bit."""
    rng = np.random.default_rng(5)
    lows = (rng.random((6, 8, 8, 3)) * 255).astype(np.uint8)
    imgs = np.stack([np.asarray(Image.fromarray(lo).resize((64, 64), Image.BILINEAR))
                     for lo in lows])
    feats, valid = descriptor.describe_batch(imgs)
    pipe = ppipe.BoVWPipeline(n_clusters=6, kmeans_niter=4, kmeans_nredo=1,
                              device="cpu").fit(feats, valid)
    staged = torch.from_numpy(pipe.transform(*descriptor.describe_batch(imgs[:3])))
    if normalize:
        staged = l2_normalize(staged)
    prologue = fused.bovw_prologue(descriptor, pipe, normalize=normalize)
    got = prologue(torch.from_numpy(imgs[:3].astype(np.float32) / 255.0))
    assert torch.equal(got, staged)


def make_corpus(root, rng, groups=3, per_group=4, size=64):
    """The JAX package's end-to-end corpus: smooth images in three colour
    groups, plus per-image noise."""
    root.mkdir(parents=True)
    for g in range(groups):
        low = rng.random((8, 8, 3)) * 0.6 + 0.2
        base = np.asarray(Image.fromarray((low * 255).astype(np.uint8)).resize(
            (size, size), Image.BILINEAR), np.float32) / 255.0
        base[:, : size // 2] *= ([1.0, 0.3, 0.3], [0.3, 1.0, 0.3], [0.3, 0.3, 1.0])[g]
        for i in range(per_group):
            img = np.clip(base + 0.02 * rng.standard_normal((size, size, 3)), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(root / f"g{g}_{i}.png")


def assert_same_ranking(got, want, tol=TOL):
    """(distance, thumb, path) lists: distances within ``tol`` rank by
    rank, and each differing id a swap of distances tied within ``tol``
    (or a tie at the last rank)."""
    gd, wd = np.array([r[0] for r in got]), np.array([r[0] for r in want])
    np.testing.assert_allclose(gd, wd, atol=tol)
    wdist = {r[2]: r[0] for r in want}
    for j, r in enumerate(got):
        if r[2] != want[j][2]:
            assert abs(wdist.get(r[2], wd[-1]) - wd[j]) <= tol, (j, got, want)


def post_image(url, data):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"q.png\"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_daisy_index_and_serve_across_the_packages(tmp_path):
    """Both indexers build a DAISY BoVW index (k = 8, cosine) over the same
    PNGs; each package's engine serves both artifact sets, and the port's
    answers are the JAX engine's on the same artifacts. The port's HTTP
    server answers as its engine."""
    make_corpus(tmp_path / "images", np.random.default_rng(0))
    common = dict(data_dir=tmp_path / "images", resize_size=64, num_clusters=8,
                  daisy_step=16, daisy_radius=16, num_images_to_return=5)
    jax_indexer_main(JaxConfig(artifacts_dir=tmp_path / "jax", method=JaxMethod.BOVW,
                               corner_descriptor=JaxKind.DAISY,
                               index_type=JaxIndexType.COSINE, **common))
    port_indexer.cli_main(["--data-dir", str(tmp_path / "images"), "--artifacts-dir",
                           str(tmp_path / "port"), "--method", "bovw", "--index-type", "cosine",
                           "--corner-descriptor", "daisy", "--num-clusters", "8",
                           "--daisy-step", "16", "--daisy-radius", "16", "--resize-size", "64",
                           "--device", "cpu"])
    for art in ("jax", "port"):
        assert (tmp_path / art / "bovw_pipeline.npz").exists()
        assert (tmp_path / art / "bovw.index.npz").exists()
        assert (tmp_path / art / "descriptions_daisy.npz").exists()
    for art in ("jax", "port"):
        jcfg = JaxConfig(artifacts_dir=tmp_path / art, method=JaxMethod.BOVW,
                         index_type=JaxIndexType.COSINE, **common)
        pcfg = Config(artifacts_dir=tmp_path / art, method=Method.BOVW,
                      index_type=IndexType.COSINE, **common)
        jax_engine = JaxQueryEngine(jcfg)
        engine = port_engine.QueryEngine(pcfg, device="cpu")
        try:
            assert engine.index.ntotal == 12 and engine.index.metric == "cosine"
            for path in engine.paths:
                want = jax_engine.query(load_image(path))
                got = engine.query(load_image(path))
                assert_same_ranking(got, want)
                names = [r[2] for r in got]
                assert path in names and all(n.split("/")[-1][:2] == path.split("/")[-1][:2]
                                             for n in names[:3])
            if art == "port":
                check_http(engine, jax_engine)
        finally:
            engine.close()


def check_http(engine, jax_engine):
    httpd = port_engine.QueryHTTPServer(("127.0.0.1", 0), port_engine.make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with open(engine.paths[7], "rb") as f:
            got = post_image(f"http://127.0.0.1:{httpd.server_address[1]}/similar_images",
                             f.read())["prediction"]
        assert_same_ranking(got, jax_engine.query(load_image(engine.paths[7])))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
