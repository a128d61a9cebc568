"""The port across processes on the CPU: two processes join one gloo job
through ``parallel/mesh.init_multihost`` and hold one shard each of a
global mesh (the counterpart of ``tests/test_multihost_dcn.py``).

  * ``distributed_topk`` and ``ShardedIVF.search`` across the process
    boundary equal the one-process answers on the same data (the exact
    flat search: equal ids and distances to 1e-5, every certificate true);
  * the engine serves a query that reaches process 0 only, unbatched and
    with ``--micro-batch on``: process 0's dispatches broadcast to process
    1, which replays them in ``worker_loop`` and exits on the sentinel;
    the answer equals the one-process engine's.

Each process runs in a subprocess of its own (process-group state is
process-wide), with one torch thread, the process group's timeout, and a
bounded wait here. Skips, with the reason, where localhost sockets are refused.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_COMMON = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
from image_search_engine_tpu_torch.parallel.mesh import init_multihost, make_mesh

assert init_multihost(f"127.0.0.1:{port}", 2, pid, device="cpu") == 2
"""

_SEARCH_WORKER = _COMMON + r"""
from image_search_engine_tpu_torch.index.store import VectorStore
from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.parallel.topk import distributed_topk

# both processes hold the same seeded corpus; the reference is the
# one-process search over the same shards, and a float64 brute force
rng = np.random.default_rng(7)
n, d, nq, k = 101, 16, 5, 8
x = rng.standard_normal((n, d)).astype(np.float32)
qs = rng.standard_normal((nq, d)).astype(np.float32)
ref_d2 = ((qs[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
ref_ids = np.argsort(ref_d2, axis=1, kind="stable")[:, :k]
q = torch.from_numpy(qs)

for local in (1, 2):  # one shard a process, then two
    mesh = make_mesh(local, "cpu")
    assert (mesh.size, mesh.world, mesh.rank, mesh.staged) == (2 * local, 2, pid, True)
    one = Mesh(["cpu"] * mesh.size)
    for dtype, metric in (("f32", "l2"), ("bf16", "ip"), ("int8", "l2")):
        st, st1 = (VectorStore.build(x, dtype=dtype, mesh=m) for m in (mesh, one))
        for use_kernels in (False, True):
            dd, ii, cert = distributed_topk(q, st.vectors, st.norms, k, metric, mesh,
                                            use_kernels=use_kernels, scales_shards=st.scales,
                                            with_certificate=True)
            d1, i1, c1 = distributed_topk(q, st1.vectors, st1.norms, k, metric, one,
                                          use_kernels=use_kernels, scales_shards=st1.scales,
                                          with_certificate=True)
            assert bool(cert.all()) and bool(c1.all()), (cert, c1)
            assert ii.dtype == torch.int32 and torch.equal(ii, i1), (ii, i1)
            torch.testing.assert_close(dd, d1, rtol=1e-5, atol=1e-5)
            if dtype == "f32":
                assert (ii.numpy() == ref_ids).all(), (ii, ref_ids)
    print(f"proc {pid}: distributed_topk ok ({local} shard(s) a process)", flush=True)

    cents = x[rng.choice(n, 4, replace=False)]
    dv, iv = ShardedIVF.from_components(x, cents, nprobe=4, mesh=mesh).search(qs, k)
    d1, i1 = ShardedIVF.from_components(x, cents, nprobe=4, mesh=one).search(qs, k)
    assert (iv == i1).all() and np.allclose(dv, d1, rtol=1e-5, atol=1e-5), (iv, i1)
    # every cell probed: the exact answer
    assert (np.sort(iv, 1) == np.sort(ref_ids, 1)).all(), (iv, ref_ids)
    print(f"proc {pid}: sharded-ivf ok ({local} shard(s) a process)", flush=True)
"""

_ENGINE_WORKER = _COMMON + r"""
workdir = sys.argv[3]
micro = len(sys.argv) > 4 and sys.argv[4] == "micro"
from pathlib import Path
from PIL import Image

# the same corpus in each process's own directory: the artifacts agree in
# content, and no file is shared
root = Path(workdir) / f"proc{pid}"
img_dir = root / "images"
img_dir.mkdir(parents=True, exist_ok=True)
rng = np.random.default_rng(11)
for g in range(3):
    low = rng.random((8, 8, 3)) * 0.6 + 0.2
    base = np.asarray(Image.fromarray((low * 255).astype(np.uint8)).resize(
        (48, 48), Image.BILINEAR), np.float32) / 255.0
    for i in range(4):
        img = np.clip(base + 0.02 * rng.standard_normal((48, 48, 3)), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / f"g{g}_{i}.png")

mesh = make_mesh(None, "cpu")
from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu_torch.engine import QueryEngine
from image_search_engine_tpu_torch.indexer import main as indexer_main
from image_search_engine_tpu_torch.utils.imageio import load_image

cfg = Config(
    data_dir=img_dir, artifacts_dir=root / "artifacts", method=Method.DNN,
    dnn_model=DnnModel.RESNET_TINY, index_type=IndexType.L2, resize_size=32,
    embed_batch_size=4, num_images_to_return=5, precompute_thumbnails=False,
    micro_batch="on" if micro else "off", micro_batch_max=4, micro_batch_wait_ms=2.0)
indexer_main(cfg, device="cpu")  # each process builds its own copy, unsharded

if pid == 0:
    ref = QueryEngine(cfg, device="cpu", prewarm=False)
    img = load_image(ref.paths[2])
    ref_d, ref_i = ref._search(img, 5)
    # only process 0 receives queries; every dispatch (prewarm included)
    # broadcasts, so process 1 joins the search
    engine = QueryEngine(cfg, device="cpu", mesh=mesh, prewarm=True)
    assert engine._mh_coordinator is not None, "coordinator missing"
    d, i = engine._search(img, 5)
    assert (np.asarray(i) == np.asarray(ref_i)).all(), (i, ref_i)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), rtol=1e-5, atol=1e-5)
    pred = engine.query(img, k=5)
    assert pred[0][2] == engine.paths[2], pred[0]
    with engine._mh_coordinator.lock:
        engine._mh_coordinator.shutdown()
    engine.close()
    ref.close()
    print("proc 0: engine query over two processes matches one process", flush=True)
else:
    from image_search_engine_tpu_torch.serving.multihost import worker_loop

    engine = QueryEngine(cfg, device="cpu", mesh=mesh, prewarm=False)
    n = worker_loop(engine)  # returns on the shutdown sentinel
    engine.close()
    assert n >= 2, n
    print(f"proc 1: worker exited cleanly after {n} dispatches", flush=True)
print(f"proc {pid}: engine-dcn ok", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            pytest.skip(f"localhost sockets are refused: {e}")
        return s.getsockname()[1]


def _run_two_process(worker_src, expect_lines, extra_args=(), timeout=90):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", worker_src, str(port), str(pid),
                               *map(str, extra_args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("two-process run timed out:\n" + "\n".join(
            p.communicate()[0] or "" for p in procs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        for line in expect_lines:
            assert line.format(pid=pid) in out, out


def test_two_process_search():
    """The exact flat search (f32, bf16 and int8 stores; the plain scan and
    the kernels' plain versions) and the sharded IVF across the process
    boundary, one and two shards a process."""
    _run_two_process(_SEARCH_WORKER, [
        f"proc {{pid}}: {what} ok ({n} shard(s) a process)"
        for n in (1, 2) for what in ("distributed_topk", "sharded-ivf")])


@pytest.mark.parametrize("micro", [False, True])
def test_two_process_engine_query(tmp_path, micro):
    """Multi-process serving: only process 0 takes the query; with
    ``--micro-batch on`` the broadcast shape is the padded (4, s, s, 3) and
    prewarm's B = 4 dispatch crosses too."""
    _run_two_process(_ENGINE_WORKER, ["proc {pid}: engine-dcn ok"],
                     extra_args=[tmp_path, *(["micro"] if micro else [])])
