"""The port's main path end to end on the CPU against the JAX package's:
the same 12 images and the same ``--torch-weights`` checkpoint through both
indexers, then the port's HTTP server and the JAX engine on the same index.

Stored embeddings: per-row relative L2 error <= 3e-2 (both embed in bf16,
rounding at different places).
"""

import json
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu.indexer import main as jax_indexer_main
from image_search_engine_tpu.utils.imageio import decode_image_bytes, load_paths_csv
from image_search_engine_tpu_torch import config as port_config
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.models.resnet import ResNet18Thin


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_corpus(root, rng, groups=3, per_group=4, size=32):
    """Groups of similar smooth images (seeded colour fields + noise)."""
    root.mkdir(parents=True)
    for g in range(groups):
        low = (rng.random((4, 4, 3)) * 200 + 30).astype(np.uint8)
        base = np.asarray(Image.fromarray(low).resize((size, size), Image.BILINEAR), np.float32)
        for i in range(per_group):
            img = np.clip(base + 6 * rng.standard_normal(base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / f"g{g}_{i}.png")


def make_weights(path):
    """A resnet-tiny torchvision-layout checkpoint with non-trivial BN."""
    model = ResNet18Thin(generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.running_var.uniform_(0.5, 1.5, generator=g)
    torch.save(model.state_dict(), path)


def post_image(url, data):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"q.png\"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_index_and_serve_matches_jax(tmp_path):
    make_corpus(tmp_path / "images", np.random.default_rng(0))
    weights = tmp_path / "tiny.pth"
    make_weights(weights)
    common = dict(data_dir=tmp_path / "images", method=Method.DNN,
                  dnn_model=DnnModel.RESNET_TINY, index_type=IndexType.L2, resize_size=32,
                  embed_batch_size=4, torch_weights=weights, num_images_to_return=5)

    jax_cfg = Config(artifacts_dir=tmp_path / "jax", **common)
    jax_indexer_main(jax_cfg)
    port_art = tmp_path / "port"
    port_indexer.cli_main([
        "--data-dir", str(tmp_path / "images"), "--artifacts-dir", str(port_art),
        "--method", "dnn", "--dnn-model", "resnet-tiny", "--index-type", "l2",
        "--resize-size", "32", "--batch-size", "4", "--torch-weights", str(weights),
        "--device", "cpu"])

    # same rows in the same order, embeddings within the bf16 tolerance
    assert load_paths_csv(port_art / "images.csv") == load_paths_csv(tmp_path / "jax" / "images.csv")
    got = np.load(port_art / "dnn_resnet-tiny_l2.index.npz")["vectors"]
    want = np.load(tmp_path / "jax" / "dnn_resnet-tiny_l2.index.npz")["vectors"]
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert got.shape == want.shape == (12, 2048) and rel.max() <= 3e-2, rel
    meta = json.loads((port_art / "embedder.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "embedder.json").read_text())
    assert meta.pop("backend") == "torch" and meta == jax_meta

    # the port's server over HTTP, the JAX engine on the same (port-built) index
    cfg, device = port_engine.parse_args([
        "--artifacts-dir", str(port_art), "--dnn-model", "resnet-tiny", "--resize-size", "32",
        "--torch-weights", str(weights), "--port", "0", "--device", "cpu"])
    engine, httpd = port_engine.make_server(cfg, device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    jax_engine = JaxQueryEngine(Config(artifacts_dir=port_art, **common), prewarm=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for path in engine.paths:
            data = open(path, "rb").read()
            status, js = post_image(base + "/similar_images", data)
            # k = 20 over 12 rows: the Faiss (-1) tail is dropped from the JSON
            assert status == 200 and len(js["prediction"]) == 12
            top = js["prediction"][0]
            assert top[2] == path and top[1]  # itself first, with a thumbnail
            assert jax_engine.query(decode_image_bytes(data), k=1)[0][2] == path
        assert post_image(base + "/similar_images", b"garbage")[0] == 400
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "corpus": 12}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_engine_refuses_unported_modes(tmp_path):
    cfg = port_config.Config(artifacts_dir=tmp_path, method=port_config.Method.BOVW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_engine.QueryEngine(cfg, device="cpu")
    cfg = port_config.Config(artifacts_dir=tmp_path, index_type=port_config.IndexType.IVFPQ,
                             store_dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_indexer.main(cfg, device="cpu")


@pytest.mark.parametrize("index_type", ["ivfpq", "cell-probe"])
def test_ivf_index_and_serve(tmp_path, index_type):
    """The IVF family through the port's entry points on the CPU: the
    indexer CLI builds the index (CLI defaults: nlist 8, nprobe 5, m 16),
    the port's HTTP server answers each corpus image with itself first, and
    the JAX engine serves the port-built artifact with the same top-1."""
    make_corpus(tmp_path / "images", np.random.default_rng(1))
    weights = tmp_path / "tiny.pth"
    make_weights(weights)
    art = tmp_path / "port"
    extra = ["--pq-rerank", "8"] if index_type == "ivfpq" else []
    port_indexer.cli_main([
        "--data-dir", str(tmp_path / "images"), "--artifacts-dir", str(art),
        "--method", "dnn", "--dnn-model", "resnet-tiny", "--index-type", index_type,
        "--resize-size", "32", "--batch-size", "4", "--torch-weights", str(weights),
        "--device", "cpu", *extra])
    with np.load(art / f"dnn_resnet-tiny_{index_type}.index.npz") as z:
        assert str(z["kind"]) == ("ivfpq" if index_type == "ivfpq" else "ivf")
        assert z["vectors"].shape == (12, 2048) and z["centroids"].shape[0] == 8

    cfg, device = port_engine.parse_args([
        "--artifacts-dir", str(art), "--index-type", index_type, "--dnn-model", "resnet-tiny",
        "--resize-size", "32", "--torch-weights", str(weights), "--port", "0", "--device", "cpu"])
    engine, httpd = port_engine.make_server(cfg, device)
    assert type(engine.index).__name__ == ("IVFPQIndex" if index_type == "ivfpq" else "IVFIndex")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    jax_engine = JaxQueryEngine(Config(
        artifacts_dir=art, data_dir=tmp_path / "images", method=Method.DNN,
        dnn_model=DnnModel.RESNET_TINY, index_type=IndexType(index_type), resize_size=32,
        torch_weights=weights, num_images_to_return=5), prewarm=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for path in engine.paths:
            data = open(path, "rb").read()
            status, js = post_image(base + "/similar_images", data)
            pred = js["prediction"]
            # k = 20 over 12 rows, 5 of 8 cells probed: the (-1) tail is dropped
            assert status == 200 and 1 <= len(pred) <= 12
            dists = [p[0] for p in pred]
            assert np.isfinite(dists).all() and dists == sorted(dists)
            assert pred[0][2] == path and pred[0][1]  # itself first, with a thumbnail
            assert jax_engine.query(decode_image_bytes(data), k=1)[0][2] == path
        assert post_image(base + "/similar_images", b"garbage")[0] == 400
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "corpus": 12}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
