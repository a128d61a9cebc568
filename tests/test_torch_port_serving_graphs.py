"""The port's serving layer on the CPU: the captured-program cache and its
launch bookkeeping (through an injected fake capture backend, since a CUDA
graph needs the card), the micro-batched engine against the JAX engine,
``--micro-batch auto`` both ways, failures that stop the start, ``/stats``
against the JAX handler, the CLI flags, and the embedder's surface with the
entry-point twins (``graft_entry``, the quickstart).

The micro-batched engine's ids must equal the JAX engine's on the same
port-built index (both embed in bf16 with the same checkpoint; the slice
test, tests/test_torch_port_slice.py, holds the embeddings within 3e-2).
The f32 ``embed_iter`` is held to rtol = atol = 2e-4 against the Flax
model (tests/test_torch_port_models.py's tolerance). Every wait has a
bound.
"""

import concurrent.futures as cf
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu.engine import make_handler as jax_make_handler
from image_search_engine_tpu.engine import parse_args as jax_parse_args
from image_search_engine_tpu.models.embedder import CNNEmbedder as JaxEmbedder
from image_search_engine_tpu.models.torch_import import convert_torchvision_resnet
from image_search_engine_tpu_torch import config as port_config
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import graft_entry
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.examples import quickstart
from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
from image_search_engine_tpu_torch.models.resnet import ResNet18Thin
from image_search_engine_tpu_torch.models.weights import state_dict_from_flax
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.serving import batching, fused
from image_search_engine_tpu_torch.serving.http import make_handler
from image_search_engine_tpu_torch.utils.imageio import load_image

WAIT_S = 60.0  # the bound on every wait below


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The program cache and its launch bookkeeping (a fake capture backend)
# ---------------------------------------------------------------------------


class FakeGraphs:
    """Stands in for fused.CudaGraphs on the CPU. ``capture`` runs the
    dispatch once, as a capture traces it (moving the launch counters a
    real capture moves too); ``replay`` recomputes the outputs into the
    captured tensors, or, with ``rerun=False``, does nothing, as a graph's
    replay moves no Python counter."""

    def __init__(self, rerun: bool = True):
        self.rerun = rerun
        self.warmed = self.captured = 0

    def warm(self, run):
        self.warmed += 1
        run()

    def capture(self, run):
        self.captured += 1
        out = run()

        def replay():
            if self.rerun:
                with torch.inference_mode():
                    for o, n in zip(out, run()):
                        o.copy_(n)

        return replay, out


def _toy_search(graphs, launches_per_run=(("groupmin", "launches", 1),
                                          ("select_topt", "radix_launches", 1))):
    """A BatchedSearch whose core sums each image, bumps the given kernel
    launch counters per run (as the CUDA wrappers do), and keys on (k,)."""

    def prologue(x):
        return x.reshape(x.shape[0], -1).sum(1, keepdim=True)

    def core(feats, k, t_margin):
        for name, attr, n in launches_per_run:
            fn = getattr(T, name)
            setattr(fn, attr, getattr(fn, attr) + n)
        d = feats + torch.arange(k, dtype=torch.float32)[None] + (t_margin or 0)
        return d, torch.arange(k).expand(feats.shape[0], k).contiguous()

    def epilogue(out, k, retry):
        return tuple(t.clone().numpy() for t in out)

    return fused.make_batched_search(prologue, core, lambda k: min(k, 7), epilogue, "cpu",
                                     graphs=graphs)


def test_program_cache_keys_on_batch_shape_statics_and_margin():
    bs = _toy_search(FakeGraphs())
    img = np.ones((1, 4, 4, 3), np.float32)
    img8 = np.ones((8, 4, 4, 3), np.float32)
    bs.dispatch(img, 5)
    bs.dispatch(img, 5)  # replayed, no new program
    bs.dispatch(img8, 5)
    bs.dispatch(img, 5, 32)
    bs.dispatch(img, 3)
    bs.dispatch(img, 9)  # clamps to 7
    bs.dispatch(img, 12)  # clamps to 7 too: the same program
    bs.dispatch(np.ones((1, 6, 6, 3), np.float32), 5)
    assert set(bs.programs) == {(1, (4, 4, 3), 5, None), (8, (4, 4, 3), 5, None),
                                (1, (4, 4, 3), 5, 32), (1, (4, 4, 3), 3, None),
                                (1, (4, 4, 3), 7, None), (1, (6, 6, 3), 5, None)}
    assert bs.graphs.captured == bs.graphs.warmed == 6 == bs.eager_runs
    assert bs.replays == 8
    assert [p.replays for p in bs.programs.values()] == [2, 1, 1, 1, 2, 1]


def test_replay_equals_the_eager_dispatch_and_reads_the_new_images():
    bs = _toy_search(FakeGraphs())
    rng = np.random.default_rng(0)
    for _ in range(3):
        img = rng.random((8, 4, 4, 3)).astype(np.float32)
        for t_margin in (None, 32):
            got = [t.clone() for t in bs.dispatch(img, 5, t_margin)]
            want = bs.raw_dispatch(img, 5, t_margin)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    d, _ = bs(np.full((1, 4, 4, 3), 0.5, np.float32), 4)
    np.testing.assert_array_equal(d, [[24.0, 25.0, 26.0, 27.0]])


def test_replays_count_the_launches_their_capture_recorded():
    T.reset_launch_counts()
    bs = _toy_search(FakeGraphs(rerun=False),
                     (("groupmin", "launches", 1), ("groupmin", "tensor_core_launches", 1),
                      ("select_topt", "launches", 1), ("select_topt", "radix_launches", 1),
                      ("rescore", "launches", 2)))
    img = np.ones((1, 4, 4, 3), np.float32)
    before = fused.launch_counters()
    bs.dispatch(img, 5)  # warm run (counted: it launched), capture (put back), one replay
    after = fused.launch_counters()
    moved = {(fn.__name__, a): after[(fn, a)] - n for (fn, a), n in before.items()
             if after[(fn, a)] != n}
    per_run = {("groupmin", "launches"): 1, ("groupmin", "tensor_core_launches"): 1,
               ("select_topt", "launches"): 1, ("select_topt", "radix_launches"): 1,
               ("rescore", "launches"): 2}
    assert moved == {key: 2 * n for key, n in per_run.items()}
    prog = next(iter(bs.programs.values()))
    assert {(fn.__name__, a): n for (fn, a), n in prog.launches.items()} == per_run
    T.reset_launch_counts()
    for _ in range(3):
        bs.dispatch(img, 5)
    assert (T.groupmin.launches, T.groupmin.tensor_core_launches, T.select_topt.launches,
            T.select_topt.radix_launches, T.rescore.launches) == (3, 3, 3, 3, 6)
    assert T.select_topt.extract_min_launches == 0 and T.groupmin_q8.launches == 0
    T.reset_launch_counts()


def test_launch_counters_cover_every_counting_wrapper():
    from image_search_engine_tpu_torch.ops import groupmin_variants as GV
    from image_search_engine_tpu_torch.ops import ivf as IV
    from image_search_engine_tpu_torch.ops import kmeans as KM
    from image_search_engine_tpu_torch.ops import rescore_variants as RV
    from image_search_engine_tpu_torch.ops import topk_merged as TM

    keys = {(fn.__name__, a) for fn, a in fused.launch_counters()}
    for want in [("groupmin", "launches"), ("groupmin", "tensor_core_launches"),
                 ("select_topt", "radix_launches"), ("select_topt", "extract_min_launches"),
                 ("rescore", "tensor_core_launches"), ("groupmin_q8", "launches"),
                 ("rescore_q8", "launches"), ("group_order", "launches"),
                 ("probed_scan", "slot_launches"), ("probed_scan", "bucket_launches"),
                 ("assign", "launches"), ("topk_running", "staged_launches"),
                 ("merged_candidates", "tensor_core_launches")]:
        assert want in keys, want
    for mod in (T, IV, KM, TM, GV, RV):  # every counting wrapper of the ops
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                for attr in vars(fn) if hasattr(fn, "__dict__") else ():
                    if attr.endswith("launches"):
                        assert (name, attr) in keys, (mod.__name__, name, attr)


def test_a_failed_capture_raises_and_keeps_no_program():
    class Broken(FakeGraphs):
        def capture(self, run):
            raise RuntimeError("operation not permitted when stream is capturing")

    bs = _toy_search(Broken())
    with pytest.raises(RuntimeError, match="capturing"):
        bs.dispatch(np.ones((1, 4, 4, 3), np.float32), 5)
    assert bs.programs == {} and bs.replays == 0


def test_the_cpu_dispatch_runs_eagerly():
    bs = _toy_search(None)
    img = np.ones((2, 4, 4, 3), np.float32)
    for g, w in zip(bs.dispatch(img, 5), bs.raw_dispatch(img, 5)):
        assert torch.equal(g, w)
    assert bs.graphs is None and bs.programs == {} and bs.eager_runs == 1 and bs.replays == 0


# ---------------------------------------------------------------------------
# The engine on the CPU (resnet-tiny at 32 px, flat l2 f32)
# ---------------------------------------------------------------------------


def make_corpus(root, rng, groups=3, per_group=4, size=32):
    """Groups of similar smooth images (seeded colour fields + noise)."""
    root.mkdir(parents=True)
    for g in range(groups):
        low = (rng.random((4, 4, 3)) * 200 + 30).astype(np.uint8)
        base = np.asarray(Image.fromarray(low).resize((size, size), Image.BILINEAR), np.float32)
        for i in range(per_group):
            img = np.clip(base + 6 * rng.standard_normal(base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / f"g{g}_{i}.png")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 PNGs, a resnet-tiny checkpoint with non-trivial BN, and the
    port's flat l2 index of them (port indexer CLI on the CPU)."""
    root = tmp_path_factory.mktemp("serving_graphs")
    make_corpus(root / "images", np.random.default_rng(0))
    model = ResNet18Thin(generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.running_var.uniform_(0.5, 1.5, generator=g)
    weights = root / "tiny.pth"
    torch.save(model.state_dict(), weights)
    art = root / "port"
    port_indexer.cli_main([
        "--data-dir", str(root / "images"), "--artifacts-dir", str(art), "--method", "dnn",
        "--dnn-model", "resnet-tiny", "--index-type", "l2", "--resize-size", "32",
        "--batch-size", "4", "--torch-weights", str(weights), "--device", "cpu"])
    return root, art, weights


def _port_engine(corpus, *flags, prewarm=None, **cfg_kw):
    _, art, weights = corpus
    cfg, device = port_engine.parse_args([
        "--artifacts-dir", str(art), "--dnn-model", "resnet-tiny", "--resize-size", "32",
        "--torch-weights", str(weights), "--device", "cpu", *flags])
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    return port_engine.QueryEngine(cfg, device=device,
                                   prewarm=cfg.prewarm if prewarm is None else prewarm)


def test_micro_batched_engine_serves_each_rider_the_jax_engines_ids(corpus):
    root, art, weights = corpus
    # no prewarm: its lone searches would ride the batcher and each wait
    # out the (long) collect wait; six riders fill a batch without waiting
    engine = _port_engine(corpus, "--micro-batch", prewarm=False, micro_batch_max=6,
                          micro_batch_wait_ms=WAIT_S * 1e3)
    jax_engine = JaxQueryEngine(Config(
        artifacts_dir=art, data_dir=root / "images", method=Method.DNN,
        dnn_model=DnnModel.RESNET_TINY, index_type=IndexType.L2, resize_size=32,
        torch_weights=weights, num_images_to_return=5), prewarm=False)
    try:
        assert engine._use_batcher and engine.cfg.micro_batch_mode() == "on"
        eager_before = engine._batched_search.eager_runs
        riders = range(6)

        def one(i):
            return i, engine.query(load_image(engine.paths[i]), k=3)

        with cf.ThreadPoolExecutor(6) as pool:
            results = [f.result(timeout=WAIT_S) for f in [pool.submit(one, i) for i in riders]]
        # six riders, one padded batch of micro_batch_max = 6
        assert engine._batched_search.eager_runs == eager_before + 1
        for i, pred in results:
            assert len(pred) == 3 and pred[0][2] == engine.paths[i]  # its own result
            want = jax_engine.query(load_image(engine.paths[i]), k=3)
            assert [p[2] for p in pred] == [p[2] for p in want]
            np.testing.assert_allclose([p[0] for p in pred], [p[0] for p in want],
                                       rtol=0.1, atol=0.05)
    finally:
        engine.close()
    assert not engine._batcher._worker.is_alive()


def test_engine_replays_through_a_capture_backend(corpus, monkeypatch):
    """The engine's served path through the capture branch (the fake
    backend recomputes on replay): prewarm captures B = 1, B = 6 and the
    wide margin; queries then replay and answer as the eager engine does."""
    eager = _port_engine(corpus, prewarm=False)
    make = fused.make_batched_search
    monkeypatch.setattr(fused, "make_batched_search",
                        lambda *a, **kw: make(*a, **kw, graphs=FakeGraphs()))
    engine = _port_engine(corpus, "--micro-batch", "on", "--prewarm-wide-margin",
                          micro_batch_max=6)
    try:
        bs = engine._batched_search
        k = engine.cfg.num_images_to_return
        k_eff = 12  # the corpus: statics_fn clamps k to the rows
        assert set(bs.programs) == {(1, (32, 32, 3), k_eff, None), (6, (32, 32, 3), k_eff, None),
                                    (1, (32, 32, 3), k_eff, fused.WIDE_MARGIN)}
        assert bs.eager_runs == 3
        for i in (0, 5, 11):
            img = load_image(engine.paths[i])
            assert engine.query(img, k=k) == eager.query(img, k=k)
        assert bs.eager_runs == 3  # every served query replayed
    finally:
        engine.close()
        eager.close()


def test_a_capture_failure_stops_the_start(corpus, monkeypatch):
    class Broken(FakeGraphs):
        def capture(self, run):
            raise RuntimeError("operation not permitted when stream is capturing")

    make = fused.make_batched_search
    monkeypatch.setattr(fused, "make_batched_search",
                        lambda *a, **kw: make(*a, **kw, graphs=Broken()))
    with pytest.raises(RuntimeError, match="capturing"):
        _port_engine(corpus)


def test_micro_batch_auto_calibrates_at_prewarm(corpus, monkeypatch):
    seen = {}

    def pays_5x(batched_search, image_shape, k, max_batch, reps=3):
        seen["args"] = (image_shape, k, max_batch)
        # drive the real path once so a broken dispatch still fails here
        batched_search(np.zeros((1, *image_shape), np.float32), k)
        return 10.0, 2.0

    monkeypatch.setattr(batching, "measure_micro_batch_gain", pays_5x)
    engine = _port_engine(corpus, "--micro-batch", "auto")
    try:
        assert engine._use_batcher is True and engine._mb_calibrated is True
        assert seen["args"] == ((32, 32, 3), 12, engine.cfg.micro_batch_max)
        assert engine.mb_calibration == {"threaded_ms_per_query": 10.0,
                                         "batched_ms_per_query": 2.0, "batching": True}
        pred = engine.query(load_image(engine.paths[0]), k=3)
        assert pred[0][2] == engine.paths[0] and engine._batcher is not None
    finally:
        engine.close()

    monkeypatch.setattr(batching, "measure_micro_batch_gain", lambda *a, **kw: (5.0, 5.0))
    engine2 = _port_engine(corpus, "--micro-batch", "auto")
    try:
        assert engine2._use_batcher is False and engine2._mb_calibrated is True  # a tie
        pred = engine2.query(load_image(engine2.paths[1]), k=3)
        assert pred[0][2] == engine2.paths[1] and engine2._batcher is None
    finally:
        engine2.close()


def test_a_calibration_failure_stops_the_start(corpus, monkeypatch):
    """The JAX engine logs a failed calibration and serves unbatched; the
    port's prewarm has run both programs by then, so the failure is a
    kernel or capture fault and the start fails."""
    def broken(*a, **kw):
        raise RuntimeError("calibration dispatch failed")

    monkeypatch.setattr(batching, "measure_micro_batch_gain", broken)
    with pytest.raises(RuntimeError, match="calibration dispatch failed"):
        _port_engine(corpus, "--micro-batch", "auto")


def test_micro_batch_auto_without_prewarm_serves_unbatched(corpus, caplog):
    with caplog.at_level("WARNING"):
        engine = _port_engine(corpus, "--micro-batch", "auto", "--no-prewarm")
    try:
        assert "needs prewarm to calibrate" in caplog.text
        assert engine._use_batcher is False and engine._mb_calibrated is False
        assert engine.query(load_image(engine.paths[2]), k=2)[0][2] == engine.paths[2]
    finally:
        engine.close()


@pytest.mark.parametrize("argv", [
    [], ["--micro-batch"], ["--micro-batch", "off"], ["--micro-batch", "on"],
    ["--micro-batch", "auto", "--prewarm-wide-margin"], ["--prewarm-wide-margin", "--no-prewarm"]])
def test_cli_flags_match_the_jax_engines(argv, tmp_path):
    cfg, device = port_engine.parse_args(["--artifacts-dir", str(tmp_path), *argv])
    want = jax_parse_args(["--artifacts-dir", str(tmp_path), *argv])
    assert device == "cuda"
    assert cfg.micro_batch_mode() == want.micro_batch_mode()
    assert (cfg.prewarm_wide, cfg.prewarm) == (want.prewarm_wide, want.prewarm)


def test_nothing_raises_not_ported_for_serving():
    """No module of the port raises ``NotImplementedError`` for an unported
    path: the refusal helper is gone and no source raises the error."""
    import importlib.util
    from pathlib import Path

    import image_search_engine_tpu_torch as port

    assert importlib.util.find_spec("image_search_engine_tpu_torch.utils.unported") is None
    root = Path(port.__file__).parent
    sources = sorted(root.rglob("*.py"))
    assert len(sources) >= 60
    for src in sources:
        text = src.read_text()
        assert "NotImplementedError" not in text and "not_ported" not in text, src


# ---------------------------------------------------------------------------
# /stats against the JAX handler
# ---------------------------------------------------------------------------


class _Stats:
    def snapshot(self):
        return {"count": 3, "errors": 0, "p50_ms": 1.5, "certificate_escalations": 0}


class _Engine:
    """What both handlers read for GET /stats."""

    def __init__(self, mode, **attrs):
        self.paths = []
        self.stats = _Stats()
        self.cfg = port_config.Config(micro_batch=mode)
        for k, v in attrs.items():
            setattr(self, k, v)


def _get_stats(handler_cls) -> dict:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.01},
                              daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/stats",
                                    timeout=WAIT_S) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=WAIT_S)
    assert not thread.is_alive()


@pytest.mark.parametrize("mode,attrs,block", [
    ("off", {"_use_batcher": False}, None),
    ("on", {"_use_batcher": True, "_mb_calibrated": False}, {"mode": "on", "active": True}),
    ("auto", {"_use_batcher": True, "_mb_calibrated": True},
     {"mode": "auto", "active": True, "calibrated": True}),
    ("auto", {"_use_batcher": False, "_mb_calibrated": True},
     {"mode": "auto", "active": False, "calibrated": True}),
    ("auto", {}, {"mode": "auto", "active": False, "calibrated": False}),
])
def test_stats_micro_batch_block_matches_the_jax_handler(mode, attrs, block):
    engine = _Engine(mode, **attrs)
    got = _get_stats(make_handler(engine))
    assert got == _get_stats(jax_make_handler(engine))
    assert got.get("micro_batch") == block
    assert {k: v for k, v in got.items() if k != "micro_batch"} == _Stats().snapshot()


# ---------------------------------------------------------------------------
# The embedder's surface and the entry-point twins
# ---------------------------------------------------------------------------


def test_embed_iter_matches_the_jax_embedder_on_carried_parameters():
    sd = {k: v.numpy() for k, v in ResNet18Thin(generator=torch.Generator().manual_seed(2))
          .state_dict().items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_torchvision_resnet(sd, (1, 1, 1, 1))
    rng = np.random.default_rng(3)
    batches = [(rng.random((n, 32, 32, 3)) * 255).astype(np.uint8) for n in (2, 3)]
    want = JaxEmbedder("resnet-tiny", image_size=32, batch_size=2, dtype=jnp.float32,
                       params=params, batch_stats=stats).embed_iter(batches)
    port = CNNEmbedder("resnet-tiny", image_size=32, batch_size=2, dtype=torch.float32,
                       device="cpu", state_dict=state_dict_from_flax(params, stats, (1, 1, 1, 1)))
    got = port.embed_iter(iter(batches))  # a one-pass iterable
    assert got.shape == want.shape == (5, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got, np.concatenate([port.embed_batch(b) for b in batches]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embedder_save_load_round_trip_is_bit_equal(tmp_path, dtype):
    a = CNNEmbedder("resnet-tiny", image_size=32, dtype=dtype, device="cpu", seed=0)
    b = CNNEmbedder("resnet-tiny", image_size=32, dtype=dtype, device="cpu", seed=1)
    imgs = (np.random.default_rng(4).random((2, 32, 32, 3)) * 255).astype(np.uint8)
    assert not np.array_equal(a.embed_batch(imgs), b.embed_batch(imgs))
    a.save(tmp_path / "emb.pt")
    assert b.load(tmp_path / "emb.pt") is b
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    np.testing.assert_array_equal(a.embed_batch(imgs), b.embed_batch(imgs))


def test_graft_entry_on_a_tiny_variant():
    fn, args = graft_entry.entry(device="cpu", model_name="resnet-tiny", image_size=32,
                                 batch_size=2)
    (images,) = args
    assert images.shape == (2, 32, 32, 3) and images.dtype == torch.float32
    out = fn(*args)
    assert out.shape == (2, 2048) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    ref = CNNEmbedder("resnet-tiny", image_size=32, device="cpu").embed(images)
    assert torch.equal(out, ref)


def test_quickstart_twin_on_the_cpu(tmp_path, capsys):
    results = quickstart.main(["--device", "cpu", "--work-dir", str(tmp_path)])
    first = sorted((tmp_path / "images").glob("*.png"))[0]
    assert len(results) == 5 and results[0][2] == str(first) and results[0][0] == 0.0
    assert f"querying with {first}" in capsys.readouterr().out
    # --method dhash runs too: the first image's hash first, at distance 0
    results = quickstart.main(["--device", "cpu", "--method", "dhash", "--work-dir",
                               str(tmp_path / "dhash")])
    first = sorted((tmp_path / "dhash" / "images").glob("*.png"))[0]
    assert len(results) == 5 and results[0][2] == str(first) and results[0][0] == 0
