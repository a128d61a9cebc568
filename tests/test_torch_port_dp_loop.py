"""The data-parallel trainer's loop and index building on the CPU, at tiny
shapes: ``train.main([..., "--sharded", "2", "--device", "cpu"])`` trains
an epoch over two shards of the CPU, saves its best checkpoint and writes
its metrics, and a second run resumes from it; ``create_index(mesh=)``
gives the unsharded index's rows, ids and scores.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.training.siamese import train as port_train
from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.create_index import create_index
from image_search_engine_tpu_torch.utils.checkpoint import load_tree_file

SIZE, DIM = 32, 8


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    """8 training and 4 validation card PNGs (32 px)."""
    root = tmp_path_factory.mktemp("cards")
    rng = np.random.default_rng(3)
    for split, n in (("train", 8), ("valid", 4)):
        (root / split).mkdir()
        for i in range(n):
            low = (rng.random((6, 6, 3)) * 255).astype(np.uint8)
            Image.fromarray(low).resize((SIZE, SIZE)).save(root / split / f"card_{i}.png")
    return root


def test_cli_trains_sharded_saves_and_resumes(cards, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the metrics file's default is relative
    argv = ["--train-dir", str(cards / "train"), "--valid-dir", str(cards / "valid"),
            "--ckpt-dir", str(tmp_path / "ckpts"), "--backbone", "densenet-tiny",
            "--image-size", str(SIZE), str(SIZE), "--embedding-dim", str(DIM),
            "--batch-size", "4", "--unfreeze-backbone", "--compute-dtype", "f32",
            "--loss", "triplet", "--sharded", "2", "--device", "cpu"]
    first = port_train.main(argv + ["--epochs", "1"])
    assert [r["epoch"] for r in first["history"]] == [0]
    (ckpt,) = (tmp_path / "ckpts").glob("epoch_00-*.pt")
    metrics = tmp_path / "artifacts" / "siamese_metrics.jsonl"
    assert [json.loads(line)["epoch"] for line in metrics.read_text().splitlines()] == [0]
    state = load_tree_file(ckpt)
    assert state["epoch"] == 0 and np.isfinite(state["val_loss"])

    second = port_train.main(argv + ["--epochs", "2"])  # resumes at epoch 1
    assert [r["epoch"] for r in second["history"]] == [1]
    assert [json.loads(line)["epoch"] for line in metrics.read_text().splitlines()] == [0, 1]
    for r in first["history"] + second["history"]:
        assert np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])


def test_create_index_on_a_mesh_gives_the_unsharded_index(cards, tmp_path):
    cfg = SiameseConfig(backbone="densenet-tiny", image_size=(SIZE, SIZE), embedding_dim=DIM,
                        batch_size=4, ckpt_dir=tmp_path / "ckpts", compute_dtype="f32")
    tr = port_train.Trainer(cfg, device="cpu", mesh=Mesh(["cpu"] * 2))
    a = np.stack([np.asarray(Image.open(p)) for p in sorted((cards / "train").glob("*.png"))[:4]])
    tr.train_step(a, a[::-1].copy())
    tr.save_checkpoint(0, 1.0)
    built = {}
    for name, mesh in (("one", None), ("mesh", Mesh(["cpu"] * 4))):
        built[name] = create_index(cfg, cards / "train", tmp_path / f"{name}.npz",
                                   tmp_path / f"{name}.csv", device="cpu", mesh=mesh)
    one, sharded = built["one"], built["mesh"]
    assert sharded.mesh is not None and sharded.ntotal == one.ntotal == 8
    assert torch.equal(sharded.store.values(), one.store.values())
    assert (tmp_path / "one.csv").read_text() == (tmp_path / "mesh.csv").read_text()
    rows = one.store.values().numpy()
    d1, i1 = one.search(rows, 5)
    d2, i2 = sharded.search(rows, 5)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(d2, d1, rtol=0, atol=1e-6)
    assert (i1[:, 0] == np.arange(8)).all()
    with np.load(tmp_path / "mesh.npz") as z, np.load(tmp_path / "one.npz") as w:
        np.testing.assert_array_equal(z["vectors"], w["vectors"])
