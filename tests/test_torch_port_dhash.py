"""The port's dHash against the JAX package's on the CPU.

Bits and hashes: equal bit for bit (both resize to 8 x 9 with the same
weights; the port rounds one float64 product per pass, the JAX package
sums in f32: a bit could flip only where two neighbouring samples of the
thumbnail lie within an f32 ulp, and none does on these seeded images).
Hamming distances: equal (integers). Top-k: equal ids in equal order,
ties to the lower index in both. Entry points: the same ids from both
indexers and engines, and each engine over the other's ``dhash.npz``.
"""

import http.client
import json
import threading
import urllib.request
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.config import Config as JaxConfig
from image_search_engine_tpu.config import Method as JaxMethod
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu.indexer import main as jax_indexer_main
from image_search_engine_tpu.ops import dhash as jdh
from image_search_engine_tpu.ops.image_ops import rgb_to_gray as jax_gray
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.config import Config, Method
from image_search_engine_tpu_torch.ops import dhash as pdh
from image_search_engine_tpu_torch.ops.image_ops import rgb_to_gray
from image_search_engine_tpu_torch.utils.imageio import load_image


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def smooth_images(rng, n, size):
    """n smooth RGB images in [0, 1]: seeded 8x8 colour fields, upsampled."""
    lows = (rng.random((n, 8, 8, 3)) * 255).astype(np.uint8)
    return np.stack([np.asarray(Image.fromarray(lo).resize((size, size), Image.BILINEAR),
                                np.float32) / 255.0 for lo in lows])


@pytest.mark.parametrize("size", [32, 64, 224])
def test_bits_and_hashes_equal_the_jax_package(size):
    rng = np.random.default_rng(size)
    imgs = np.concatenate([smooth_images(rng, 8, size),
                           rng.random((8, size, size, 3)).astype(np.float32)])
    want = np.asarray(jdh.dhash_bits(jax_gray(jnp.asarray(imgs))))
    got = pdh.dhash_bits(rgb_to_gray(torch.from_numpy(imgs))).numpy()
    assert got.dtype == bool and got.shape == (16, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdh.dhash_images(torch.from_numpy(imgs)),
                                  jdh.dhash_images(jnp.asarray(imgs)))
    u8 = (imgs * 255).astype(np.uint8)
    np.testing.assert_array_equal(pdh.dhash_images(torch.from_numpy(u8)),
                                  jdh.dhash_images(jnp.asarray(u8.astype(np.float32) / 255.0)))


def test_int_packing_round_trips_as_the_jax_package():
    bits = np.random.default_rng(1).random((20, 64)) < 0.5
    h = pdh.bits_to_int(bits)
    assert h.dtype == np.uint64
    np.testing.assert_array_equal(h, jdh.bits_to_int(bits))
    np.testing.assert_array_equal(pdh.int_to_bits(h), bits)
    np.testing.assert_array_equal(pdh.int_to_bits(h), jdh.int_to_bits(h))


@pytest.mark.parametrize("k", [1, 7, 40])
def test_hamming_ties_in_index_order(k):
    """A store of 40 hashes drawn from 6 distinct ones: most distances tie,
    and both packages keep equal distances in index order."""
    rng = np.random.default_rng(k)
    distinct = rng.random((6, 64)) < 0.5
    db = distinct[rng.integers(0, 6, 40)]
    q = np.concatenate([distinct[:2], rng.random((2, 64)) < 0.5])
    want = jdh.hamming_scan(jnp.asarray(q), jnp.asarray(db))
    got = pdh.hamming_scan(torch.from_numpy(q), torch.from_numpy(db))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wd, wi = jdh.hamming_topk(jnp.asarray(q), jnp.asarray(db), k)
    gd, gi = pdh.hamming_topk(torch.from_numpy(q), torch.from_numpy(db), k)
    assert gd.dtype == torch.int32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert len(np.unique(np.asarray(wd))) < np.asarray(wd).size  # ties were there to order


def make_corpus(root, rng, groups=3, per_group=4, size=48):
    root.mkdir(parents=True)
    for g in range(groups):
        base = smooth_images(rng, 1, size)[0]
        for i in range(per_group):
            img = np.clip(base + 0.02 * rng.standard_normal(base.shape), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(root / f"g{g}_{i}.png")


def multipart(data):
    """(body, headers) of an upload of ``data`` as the form's ``image``."""
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"q.png\"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def post_image(url, data):
    body, headers = multipart(data)
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_index_and_serve_match_the_jax_package(tmp_path):
    """Both indexers over the same 12 PNGs write the same bits; each
    engine serves both stores with the JAX engine's ids and distances (the
    query's own file at distance 0); the port's HTTP server answers
    with the same prediction."""
    make_corpus(tmp_path / "images", np.random.default_rng(0))
    common = dict(data_dir=tmp_path / "images", resize_size=48, num_images_to_return=5)
    jcfg = JaxConfig(artifacts_dir=tmp_path / "jax", method=JaxMethod.DHASH, **common)
    pcfg = Config(artifacts_dir=tmp_path / "port", method=Method.DHASH, **common)
    jax_indexer_main(jcfg)
    port_indexer.cli_main(["--data-dir", str(tmp_path / "images"), "--artifacts-dir",
                           str(tmp_path / "port"), "--method", "dhash", "--resize-size", "48",
                           "--device", "cpu"])
    jbits = np.load(jcfg.dhash_store_path)["bits"]
    np.testing.assert_array_equal(np.load(pcfg.dhash_store_path)["bits"], jbits)
    assert jbits.shape == (12, 64) and jbits.dtype == bool

    jax_engine = JaxQueryEngine(jcfg)
    engines = {art: port_engine.QueryEngine(Config(artifacts_dir=tmp_path / art,
                                                   method=Method.DHASH, **common),
                                            device="cpu")
               for art in ("jax", "port")}
    try:
        for i, path in enumerate(jax_engine.paths):
            img = load_image(path)
            want = [(d, p) for d, _, p in jax_engine.query(img)]
            assert (0, path) in want  # a group's images may hash alike: ties in row order
            for eng in engines.values():
                assert [(d, p) for d, _, p in eng.query(img)] == want, i
        eng = engines["port"]
        httpd = port_engine.QueryHTTPServer(("127.0.0.1", 0), port_engine.make_handler(eng))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            with open(eng.paths[5], "rb") as f:
                got = post_image(base + "/similar_images", f.read())["prediction"]
            want = jax_engine.query(load_image(eng.paths[5]))
            assert [(d, p) for d, _, p in got] == [(d, p) for d, _, p in want]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        assert not thread.is_alive()
        assert eng.index is None
    finally:
        for eng in engines.values():
            eng.close()


def test_server_holds_a_burst_of_clients(tmp_path):
    """make_server's listen backlog holds a burst of concurrent clients:
    64 connections opened before the accept loop first runs all complete
    their handshake at once (at socketserver's default backlog of 5 the
    kernel drops the handshakes beyond it, which then retry a second later
    or are reset), and each answer holds its own file at distance 0."""
    make_corpus(tmp_path / "images", np.random.default_rng(1))
    port_indexer.cli_main(["--data-dir", str(tmp_path / "images"), "--artifacts-dir",
                           str(tmp_path / "art"), "--method", "dhash", "--resize-size", "48",
                           "--device", "cpu"])
    cfg, device = port_engine.parse_args(["--artifacts-dir", str(tmp_path / "art"), "--method",
                                          "dhash", "--resize-size", "48", "--port", "0",
                                          "--device", "cpu"])
    engine, httpd = port_engine.make_server(cfg, device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    conns = []
    try:
        for _ in range(64):
            conns.append(http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                                    timeout=0.5))
            conns[-1].connect()  # times out where the kernel dropped the handshake
        thread.start()
        for i, conn in enumerate(conns):
            conn.sock.settimeout(60)
            with open(engine.paths[i % len(engine.paths)], "rb") as f:
                conn.request("POST", "/similar_images", *multipart(f.read()))
        for i, conn in enumerate(conns):
            resp = conn.getresponse()
            assert resp.status == 200, i
            pred = json.loads(resp.read())["prediction"]
            assert [0, engine.paths[i % len(engine.paths)]] in [[d, p] for d, _, p in pred], i
    finally:
        for conn in conns:
            conn.close()
        if thread.is_alive():
            httpd.shutdown()
            thread.join(timeout=30)
        httpd.server_close()
        engine.close()
    assert not thread.is_alive()
