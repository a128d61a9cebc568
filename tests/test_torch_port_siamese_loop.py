"""The port's siamese training loop, index building, evaluation and
serving, on the CPU at tiny shapes, with the JAX package's artifacts and
HTTP handler beside them (the train step itself:
tests/test_torch_port_siamese_train.py).

The JAX net is initialized once for the module and stands in for the JAX
``Trainer`` in the JAX package's ``create_index`` (its ``embed``: the
bf16 forward of ``EmbeddingNet`` over [0, 1] images); its weights go into
a port checkpoint (``state_dict_from_flax``, ``torch.save``), so both
packages' ``create_index`` embed the cards with the same net (each in its
default bf16 compute: rows within cosine 1e-2 of each other).
"""

import json
import threading
import urllib.request
import uuid
from http.server import ThreadingHTTPServer

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.engine import make_handler as jax_make_handler
from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu.training.siamese import create_index as jax_ci
from image_search_engine_tpu.ops.image_ops import to_unit_f32 as jax_to_unit_f32
from image_search_engine_tpu.training.siamese.config import SiameseConfig as JaxConfig
from image_search_engine_tpu.training.siamese.eval import query_index as jax_query_index
from image_search_engine_tpu.training.siamese.model import EmbeddingNet as FlaxEmbeddingNet
from image_search_engine_tpu_torch.examples import siamese_workflow
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.models.weights import state_dict_from_flax
from image_search_engine_tpu_torch.training.siamese import train as port_train
from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.create_index import create_index
from image_search_engine_tpu_torch.training.siamese.eval import (
    card_retrieval_metrics, make_synthetic_card_corpus, query_index, recall_at_k)
from image_search_engine_tpu_torch.training.siamese.serve import SiameseQueryEngine, make_server
from image_search_engine_tpu_torch.training.siamese.train import AverageMeter, Trainer
from image_search_engine_tpu_torch.utils.imageio import load_image, load_paths_csv

TINY = (2, 2)
B, SIZE, DIM = 4, 32, 8


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    """6 training and 4 validation card PNGs (32 px)."""
    root = tmp_path_factory.mktemp("cards")
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("valid", 4)):
        (root / split).mkdir()
        for i in range(n):
            low = (rng.random((6, 6, 3)) * 255).astype(np.uint8)
            Image.fromarray(low).resize((SIZE, SIZE)).save(root / split / f"card_{i}.png")
    return root


def tiny_cfg(root, cls=SiameseConfig, **kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("freeze_backbone", False)
    return cls(train_dir=root / "train", valid_dir=root / "valid", ckpt_dir=root / "ckpts",
               log_file=root / "metrics.jsonl", backbone="densenet-tiny",
               image_size=(SIZE, SIZE), embedding_dim=DIM, **kw)


# ---------------------------------------------------------------------------
# the loop: plateau LR, checkpoints, resume
# ---------------------------------------------------------------------------


def test_plateau_halves_the_lr_and_only_improvements_are_saved(cards, tmp_path, monkeypatch):
    cfg = tiny_cfg(cards, loss="triplet", lr=1e-2, lr_reduce_patience=1)
    cfg.ckpt_dir, cfg.log_file = tmp_path / "ckpts", tmp_path / "m.jsonl"
    tr = Trainer(cfg, device="cpu")
    vals = iter([3.0, 2.0, 2.5, 2.6, 1.0])
    monkeypatch.setattr(tr, "eval_step", lambda a, n: torch.tensor(next(vals)))
    out = tr.run(epochs=5, steps_per_epoch=1, val_steps=1)
    lrs = [r["lr"] for r in out["history"]]
    # the lr a record shows is the one its epoch trained at; a plateau halves
    # it after its epoch's record
    np.testing.assert_allclose(lrs, [1e-2, 1e-2, 1e-2, 5e-3, 2.5e-3])
    saved = sorted(p.name for p in cfg.ckpt_dir.iterdir())
    assert saved == ["epoch_00-loss_3.0000.pt", "epoch_01-loss_2.0000.pt",
                     "epoch_04-loss_1.0000.pt"]
    assert out["best_val"] == 1.0
    assert [json.loads(line)["epoch"] for line in cfg.log_file.read_text().splitlines()] == \
        [0, 1, 2, 3, 4]


def test_save_resume_and_start_epoch(cards, tmp_path):
    cfg = tiny_cfg(cards, loss="triplet", lr=1e-2)
    cfg.ckpt_dir, cfg.log_file = tmp_path / "ckpts", tmp_path / "m.jsonl"
    tr1 = Trainer(cfg, device="cpu")
    tr1.run(epochs=2, steps_per_epoch=2, val_steps=1)
    path = tr1.save_checkpoint(1, 0.0)  # the final state, as the workflow does
    tr2 = Trainer(cfg, device="cpu")
    tr2.maybe_resume()
    assert tr2.start_epoch == 2
    state = torch.load(path, weights_only=True)
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(v, state["model"][k]), k
    for p1, p2 in zip(tr1.model.parameters(), tr2.model.parameters()):
        assert torch.equal(tr1.opt.state[p1]["momentum_buffer"],
                           tr2.opt.state[p2]["momentum_buffer"])
    out = tr2.run(epochs=3, steps_per_epoch=1, val_steps=1)
    assert [r["epoch"] for r in out["history"]] == [2]


def test_average_meter_keeps_device_sums():
    m = AverageMeter()
    for v in (1.0, 2.0, 6.0):
        m.update(torch.tensor(v))
    assert torch.is_tensor(m.sum) and m.avg == 3.0


def test_sharded_raises_and_cli_defaults_to_the_card(cards, tmp_path, monkeypatch):
    """``--sharded 2 --device cpu`` trains data-parallel over two shards of
    the CPU (it raised before data-parallel training was ported); the CLI
    still defaults to the card."""
    monkeypatch.chdir(tmp_path)  # the metrics file's default is relative
    argv = ["--train-dir", str(cards / "train"), "--valid-dir", str(cards / "valid")]
    out = port_train.main(argv + [
        "--sharded", "2", "--device", "cpu", "--backbone", "densenet-tiny", "--image-size",
        str(SIZE), str(SIZE), "--embedding-dim", str(DIM), "--batch-size", str(B),
        "--epochs", "1", "--ckpt-dir", str(tmp_path / "ckpts"), "--compute-dtype", "f32"])
    assert [r["epoch"] for r in out["history"]] == [0] and np.isfinite(out["best_val"])
    assert len(list((tmp_path / "ckpts").glob("epoch_00-*.pt"))) == 1
    cfg, a = port_train.parse_args(argv)
    assert a.device == "cuda" and cfg.compute_dtype == "bf16" and cfg.freeze_backbone
    assert a.sharded is None and port_train.parse_args(argv + ["--sharded"])[1].sharded == 0


# ---------------------------------------------------------------------------
# create_index, eval and serving; artifacts across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built(cards):
    """One JAX ``Trainer``'s weights in a port checkpoint; each package's
    index and manual matrix over the training cards with those weights."""
    jcfg = tiny_cfg(cards, cls=JaxConfig, loss="triplet")
    model = FlaxEmbeddingNet(embedding_dim=DIM, freeze_backbone=False, backbone="densenet-tiny",
                             dtype=jnp.bfloat16)
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=False))()
    forward = jax.jit(lambda v, x: model.apply(v, jax_to_unit_f32(x), train=False))
    jax_trainer = SimpleNamespace(  # what create_index uses of the JAX Trainer
        embed=lambda images, batch_size=32: np.asarray(forward(variables, jnp.asarray(images))))
    cfg = tiny_cfg(cards, loss="triplet")
    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"], TINY, arch="siamese"), strict=False)
    ckpt = tr.save_checkpoint(0, 1.0)
    out = {"ckpt": ckpt}
    out["port"] = (create_index(cfg, cards / "train", cards / "port.index.npz",
                                cards / "port.csv", device="cpu"),
                   create_index(cfg, cards / "train", cards / "port_manual.npz",
                                cards / "port.csv", manual=True, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:  # the module's trainer, built once
        mp.setattr(jax_ci, "Trainer", lambda cfg, mesh=None: jax_trainer)
        mp.setattr(jax_ci, "get_latest_checkpoint", lambda d: None)
        jax_ci.create_index(jcfg, cards / "train", cards / "jax.index.npz", cards / "jax.csv")
        jax_ci.create_index(jcfg, cards / "train", cards / "jax_manual.npz", cards / "jax.csv",
                            manual=True)
    return out


def test_create_index_flat_equals_bruteforce(cards, built):
    index, manual = built["port"]
    assert isinstance(index, FlatIndex) and index.metric == "ip"
    assert manual.shape == (6, DIM) and np.allclose(np.linalg.norm(manual, axis=1), 1, atol=1e-5)
    np.testing.assert_array_equal(np.load(cards / "port_manual.npz")["embeddings"], manual)
    _, fi = query_index(manual, index, "flat", k=6)
    _, bi = query_index(manual, manual, "bruteforce", k=6)
    assert recall_at_k(fi, bi) == 1.0
    assert (fi[:, 0] == np.arange(6)).all()  # self-match first
    with pytest.raises(ValueError, match="backend"):
        query_index(manual, manual, "faiss")


def test_artifacts_cross_both_ways(cards, built):
    """The JAX package's siamese.index.npz and manual .npz load in the port
    (the same search), and the port's in the JAX package; the two packages'
    rows from the same weights agree."""
    port, jax_rows = (np.load(cards / f"{s}_manual.npz")["embeddings"] for s in ("port", "jax"))
    assert np.sum(port * jax_rows, axis=1).min() > 0.99
    for side, other in (("jax", "port"), ("port", "jax")):
        manual = np.load(cards / f"{side}_manual.npz")["embeddings"]
        port_idx = FlatIndex.load(cards / f"{side}.index.npz", device="cpu")
        jax_idx = JaxFlatIndex.load(cards / f"{side}.index.npz")
        assert port_idx.metric == jax_idx.metric == "ip" and port_idx.ntotal == 6
        d, i = query_index(manual, port_idx, "flat", k=3)
        jd, ji = jax_query_index(manual, jax_idx, "flat", k=3)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(d, np.asarray(jd), rtol=0, atol=1e-5)
    assert load_paths_csv(cards / "port.csv") == load_paths_csv(cards / "jax.csv")


def test_card_retrieval_metrics(cards):
    c, q, lab = make_synthetic_card_corpus(4, 32, q_per=2)
    tr = Trainer(tiny_cfg(cards), device="cpu")
    m = card_retrieval_metrics(lambda x: tr.embed(x), c, q, lab, device="cpu")
    assert set(m) == {"recall_at_1", "top3_hit", "gap"}
    assert 0 <= m["recall_at_1"] <= m["top3_hit"] <= 1 and np.isfinite(m["gap"])
    perfect = card_retrieval_metrics(lambda x: x.reshape(len(x), -1), c, c, np.arange(4),
                                     device="cpu")
    assert perfect["recall_at_1"] == 1.0


def post(url, data):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"q.png\"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_siamese_server_answers_with_the_jax_handlers_json(cards, built):
    """The port's engine (the port checkpoint of the JAX weights) on the
    JAX package's index, behind the port's server and behind the JAX
    package's handler: 3 requests, the same JSON; each card first, at
    cosine ~1."""
    cfg = tiny_cfg(cards)
    engine = SiameseQueryEngine(cfg, cards / "jax.index.npz", cards / "jax.csv", n_results=3,
                                checkpoint=built["ckpt"], device="cpu")
    servers = [make_server(engine, "127.0.0.1", 0),
               ThreadingHTTPServer(("127.0.0.1", 0), jax_make_handler(engine))]
    assert servers[0].request_queue_size == 1024
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        paths = load_paths_csv(cards / "jax.csv")
        for path in paths[:3]:
            data = open(path, "rb").read()
            port_js, jax_js = (post(f"http://127.0.0.1:{s.server_address[1]}/similar_images",
                                    data) for s in servers)
            assert port_js == jax_js
            top = port_js["prediction"][0]
            assert len(port_js["prediction"]) == 3 and top[2] == path and top[1]
            assert top[0] > 0.99
            assert engine.query(load_image(path))[0][2] == path
        with urllib.request.urlopen(
                f"http://127.0.0.1:{servers[0].server_address[1]}/stats", timeout=30) as r:
            assert json.load(r)["requests"] >= 3
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        engine.close()


def test_workflow_twin_on_the_cpu(cards, tmp_path):
    out = siamese_workflow.main([
        "--train-dir", str(cards / "train"), "--valid-dir", str(cards / "valid"),
        "--epochs", "1", "--steps-per-epoch", "1", "--loss", "triplet",
        "--backbone", "densenet-tiny", "--image-size", "32", "32", "--batch-size", "4",
        "--device", "cpu", "--work-dir", str(tmp_path)])
    assert out["recall"] == 1.0 and np.isfinite(out["best_val"])
    assert (tmp_path / "siamese.index.npz").exists() and (tmp_path / "manual.npz").exists()
