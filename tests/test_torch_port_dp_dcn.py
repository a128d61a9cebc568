"""Data-parallel training across processes on the CPU: two processes join
one gloo job through ``parallel/mesh.init_multihost`` and hold two shards
each of a 4-shard mesh (the counterpart of the JAX package's
``Trainer(cfg, mesh=)`` after its multi-host init).

  * one sharded step, frozen and unfrozen, equals the one-process 4-shard
    step from the same seeds at ``step_compare.STEP_BOUNDS``, and both processes'
    replicas are bit-equal after it (the BatchNorm statistics and the
    gradients cross the process boundary by all-reduce, the embeddings by
    all-gather);
  * ``eval_step`` gives both processes the one-process validation loss;
  * only process 0 writes: a checkpoint saved into a per-process
    directory exists only under process 0's, and ``Trainer.run``'s metrics
    file holds one line an epoch; both processes then resume from the
    shared checkpoint.

Each process runs in a subprocess of its own (process-group state is
process-wide), with one torch thread, the process group's timeout, and a
bounded wait here. Skips, with the reason, where localhost sockets are
refused.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import dataclasses, hashlib, json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
port, pid, root = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])
from image_search_engine_tpu_torch.parallel.mesh import Mesh, init_multihost, make_mesh
from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.step_compare import STEP_BOUNDS, step_gap
from image_search_engine_tpu_torch.training.siamese.train import Trainer

assert init_multihost(f"127.0.0.1:{port}", 2, pid, device="cpu") == 2
mesh = make_mesh(2, "cpu")
assert (mesh.size, mesh.world, mesh.rank, mesh.staged) == (4, 2, pid, True)
one_mesh = Mesh(["cpu"] * 4)
batches = np.load(root / "batches.npz")
a, n = batches["a"], batches["n"]

for frozen, loss in ((True, "circle"), (False, "self_supervised_circle")):
    cfg = SiameseConfig(train_dir=root / "train", valid_dir=root / "train",
                        ckpt_dir=root / "ckpts", log_file=root / "metrics.jsonl",
                        backbone="densenet-tiny", image_size=(32, 32), embedding_dim=8,
                        batch_size=4, compute_dtype="f32", freeze_backbone=frozen, loss=loss)
    dp, one = Trainer(cfg, device="cpu", mesh=mesh), Trainer(cfg, device="cpu", mesh=one_mesh)
    vd, vo = float(dp.eval_step(a, n)), float(one.eval_step(a, n))
    assert abs(vd - vo) <= STEP_BOUNDS["loss_rtol"] * abs(vo), (vd, vo)
    got, want = float(dp.train_step(a, n)), float(one.train_step(a, n))
    gap = step_gap(one, dp, want, got)
    assert gap["worst"] <= 1.0, gap
    digest = hashlib.sha256()
    for v in dp.model.state_dict().values():
        digest.update(v.numpy().tobytes())
    for p in dp.model.parameters():
        if p in dp.opt.state:
            digest.update(dp.opt.state[p]["momentum_buffer"].numpy().tobytes())
    every = [None, None]
    dist.all_gather_object(every, (digest.hexdigest(), got, vd))
    assert every[0] == every[1], every
    print(f"proc {pid}: step ok ({'frozen' if frozen else 'unfrozen'} {loss}, "
          f"worst {gap['worst']:.3f} of the bounds)", flush=True)

own = dataclasses.replace(cfg, ckpt_dir=root / f"own{pid}")
path = Trainer(own, device="cpu", mesh=mesh).save_checkpoint(0, 1.0)
assert path.exists() is (pid == 0) and (root / "own1").exists() is False, path
out = dp.run(epochs=2, steps_per_epoch=1, val_steps=1)
lines = [json.loads(l)["epoch"] for l in cfg.log_file.read_text().splitlines()]
assert lines == [0, 1], lines
ckpts = sorted(p.name for p in cfg.ckpt_dir.glob("*.pt"))
assert ckpts and ckpts[0].startswith("epoch_00-"), ckpts  # the first epoch always improves
resumed = Trainer(cfg, device="cpu", mesh=mesh)
resumed.maybe_resume()
assert resumed.start_epoch == int(ckpts[-1][6:8]) + 1
print(f"proc {pid}: writes ok ({ckpts}, metrics {lines})", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            pytest.skip(f"localhost sockets are refused: {e}")
        return s.getsockname()[1]


def test_two_processes_train_as_one(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "train").mkdir()
    imgs = []
    for i in range(8):
        low = (rng.random((6, 6, 3)) * 255 * (0.1 + 0.9 * i / 7)).astype(np.uint8)
        img = Image.fromarray(low).resize((32, 32), Image.BILINEAR)
        img.save(tmp_path / "train" / f"card_{i}.png")
        imgs.append(np.asarray(img))
    np.savez(tmp_path / "batches.npz", a=np.stack(imgs[:4]), n=np.stack(imgs[4:]))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(port), str(pid),
                               str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("two-process training timed out:\n" + "\n".join(
            p.communicate()[0] or "" for p in procs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        for what in ("step ok (frozen circle", "step ok (unfrozen self_supervised_circle",
                     "writes ok"):
            assert f"proc {pid}: {what}" in out, out
