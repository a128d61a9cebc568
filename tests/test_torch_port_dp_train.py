"""The port's data-parallel train step on the CPU, at tiny shapes.

A step of ``Trainer(cfg, mesh=Mesh([cpu] * S))`` (2 and 4 shards, batch 4
and 8) against the unsharded step of ``Trainer(cfg)`` from the same seeds,
so the same initial weights, global batch, augmentation draws and dropout
masks: ``densenet-tiny`` at 32 px, f32, frozen under the circle loss and
unfrozen under triplet and self-supervised circle, dropout 0 and 0.3. The
bounds are the ones ``tests/test_torch_port_siamese_train.py`` holds the
unsharded port to against the JAX package (``step_compare.STEP_BOUNDS``): the loss
rtol 1e-5, parameters atol 1e-5, every running statistic rtol 1e-5 with
atol 1e-6, the momentum trace leaf by leaf within ``trace_rtol`` of the
leaf's largest entry or ``trace_floor`` of the net's. Then the eval loss,
the running statistics updated once, the replicas bit-equal (two replicas
on the CPU stand for two devices of one process), a batch that does not
divide (against the JAX package's data-parallel program:
tests/test_torch_port_dp_jax.py).
"""

import copy

import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu_torch.parallel.data_parallel import combine_stats, reduce_gradients
from image_search_engine_tpu_torch.parallel.mesh import Mesh, gather_processes_differentiable
from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.step_compare import (
    STEP_BOUNDS, leaf_gaps, over_bound, replicas_equal)
from image_search_engine_tpu_torch.training.siamese.train import Trainer

SIZE, DIM = 32, 8


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def spread_batch(seed: int, b: int) -> np.ndarray:
    """(b, SIZE, SIZE, 3) uint8 smooth colour fields, each at its own
    brightness (x 0.1 to 1), so the head's BatchNorm columns spread."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in np.linspace(0.1, 1.0, b)[rng.permutation(b)]:
        low = (rng.random((6, 6, 3)) * 255 * scale).astype(np.uint8)
        out.append(np.asarray(Image.fromarray(low).resize((SIZE, SIZE), Image.BILINEAR)))
    return np.stack(out)


def cfg_of(tmp_path, batch, **kw):
    return SiameseConfig(backbone="densenet-tiny", image_size=(SIZE, SIZE), embedding_dim=DIM,
                         batch_size=batch, compute_dtype="f32", ckpt_dir=tmp_path / "ckpts",
                         log_file=tmp_path / "m.jsonl", **kw)


def assert_same_step(ref, other, ref_loss, other_loss):
    """``other``'s step against ``ref``'s at STEP_BOUNDS, leaf by leaf."""
    gaps = leaf_gaps(ref, other, ref_loss, other_loss)
    assert gaps["trace"] and not over_bound(gaps), over_bound(gaps)


CASES = [  # (frozen, loss, shards, batch, dropout)
    (True, "circle", 2, 4, 0.0),
    (True, "circle", 4, 8, 0.3),
    (False, "triplet", 2, 8, 0.3),
    (False, "triplet", 4, 4, 0.0),
    (False, "self_supervised_circle", 4, 8, 0.3),
    (False, "self_supervised_circle", 2, 4, 0.0),
]


@pytest.mark.parametrize("frozen,loss,shards,batch,dropout", CASES)
def test_sharded_step_is_the_unsharded_step(tmp_path, frozen, loss, shards, batch, dropout):
    cfg = cfg_of(tmp_path, batch, freeze_backbone=frozen, loss=loss)
    a, n = spread_batch(2 * batch, batch), spread_batch(2 * batch + 1, batch)
    one = Trainer(cfg, device="cpu", dropout_rate=dropout)
    dp = Trainer(cfg, device="cpu", dropout_rate=dropout, mesh=Mesh(["cpu"] * shards))
    # the eval loss: running statistics, embeddings gathered for the global loss
    va, vn = spread_batch(50, batch), spread_batch(51, batch)
    np.testing.assert_allclose(float(dp.eval_step(va, vn)), float(one.eval_step(va, vn)),
                               rtol=STEP_BOUNDS["loss_rtol"])
    assert not any(int(v) for k, v in dp.model.state_dict().items() if "num_batches" in k)
    ref_loss, got_loss = float(one.train_step(a, n)), float(dp.train_step(a, n))
    assert_same_step(one, dp, ref_loss, got_loss)
    # the running statistics moved once: frozen, only the head's
    counts = {k: int(v) for k, v in dp.model.state_dict().items() if "num_batches" in k}
    assert counts and all(v == (0 if frozen and k.startswith("backbone") else 1)
                          for k, v in counts.items()), counts
    assert replicas_equal(dp)


def test_two_replicas_stay_bit_equal(tmp_path):
    """Two replicas on one CPU stand for a process with two devices (each
    distinct device holds one): every shard on its own replica, their
    gradients summed by ``reduce_gradients``, each replica stepped by its
    own optimizer. The step is still the unsharded one, and the replicas
    bit-equal after two steps."""
    cfg = cfg_of(tmp_path, 4, freeze_backbone=False, loss="triplet")
    one = Trainer(cfg, device="cpu")
    dp = Trainer(cfg, device="cpu", mesh=Mesh(["cpu"] * 2))
    dp.replicas.append(copy.deepcopy(dp.model))
    dp.opts.append(torch.optim.SGD(dp.replicas[1].parameters(), lr=cfg.lr,
                                   momentum=cfg.momentum))
    dp._replica_of = [0, 1]
    for step in range(2):
        a, n = spread_batch(10 + 2 * step, 4), spread_batch(11 + 2 * step, 4)
        ref_loss, got_loss = float(one.train_step(a, n)), float(dp.train_step(a, n))
        if step == 0:
            assert_same_step(one, dp, ref_loss, got_loss)
        assert replicas_equal(dp)
    assert all(int(v) == 2 for k, v in dp.replicas[1].state_dict().items()
               if "num_batches" in k)


def test_reduce_gradients_sums_every_replica():
    nets = [torch.nn.Linear(3, 2) for _ in range(3)]
    for i, net in enumerate(nets):
        net.load_state_dict(nets[0].state_dict())
        net.weight.grad = torch.full_like(net.weight, float(i + 1))
        net.bias.grad = None if i == 0 else torch.ones_like(net.bias)  # only live grads
    reduce_gradients(nets, Mesh(["cpu"] * 3))
    for net in nets:
        assert torch.equal(net.weight.grad, torch.full_like(net.weight, 6.0))
    assert nets[0].bias.grad is None and torch.equal(nets[1].bias.grad, torch.ones(2))


def test_chan_combination_is_the_global_variance():
    """The shards' (count, mean, M2) merged pairwise give the whole
    batch's mean and biased variance as well as one f32 pass over the
    whole batch does, near-constant columns too (float64 reference)."""
    rng = np.random.default_rng(0)
    x = (1e3 + rng.standard_normal((40, 5)) * np.array([1e-3, 1e-1, 1, 10, 1e2])).astype(
        np.float32)
    want = x.astype(np.float64).var(0)
    errs = []
    for parts in (1, 2, 3, 4, 5):
        stats = []
        for blk in np.array_split(x, parts):  # as ShardBatchNorm: the mean in f64
            t = torch.from_numpy(blk)
            var = torch.var(t, dim=0, correction=0).double()
            stats.append((blk.shape[0], t.mean(0, dtype=torch.float64), var * blk.shape[0]))
        n, mean, m2 = combine_stats(stats)
        assert n == 40
        np.testing.assert_allclose(mean.numpy(), x.astype(np.float64).mean(0), rtol=1e-6)
        errs.append(np.abs((m2 / n).numpy() - want) / want)
    for e in errs[1:]:  # the whole batch's own f32 pass: errs[0]
        assert (e <= 2 * errs[0] + 1e-6).all(), (e, errs[0])
    t = torch.ones(3, requires_grad=True)
    g = gather_processes_differentiable(t, Mesh(["cpu"]))
    assert g.shape == (1, 3) and g.requires_grad


def test_a_batch_that_does_not_divide_raises(tmp_path):
    from image_search_engine_tpu_torch.training.siamese.dataset import PairsGenerator

    cfg = cfg_of(tmp_path, 6, freeze_backbone=True, loss="circle")
    dp = Trainer(cfg, device="cpu", mesh=Mesh(["cpu"] * 4))
    before = {k: v.clone() for k, v in dp.model.state_dict().items()}
    a = spread_batch(0, 6)
    with pytest.raises(ValueError, match="does not divide into 4 shards"):
        dp.train_step(a, a)
    paths = []
    for i, img in enumerate(a):
        paths.append(tmp_path / f"c{i}.png")
        Image.fromarray(img).save(paths[-1])
    gen = PairsGenerator(paths, 6, (SIZE, SIZE))
    with pytest.raises(ValueError, match="does not divide"):
        dp.run(gen, gen, epochs=1, steps_per_epoch=1, val_steps=1)
    assert not cfg.log_file.exists()
    assert all(torch.equal(v, before[k]) for k, v in dp.model.state_dict().items())


def test_eight_shard_threads_under_fast_switching(tmp_path):
    """Eight shard threads (more than the cores the tests give torch), the
    interpreter switching threads every microsecond: every BatchNorm's
    rendezvous still combines each shard's statistics once, so the step is
    the unsharded one; the step runs in a helper thread joined with a
    timeout."""
    import sys
    import threading

    cfg = cfg_of(tmp_path, 8, freeze_backbone=False, loss="self_supervised_circle")
    a, n = spread_batch(30, 8), spread_batch(31, 8)
    one = Trainer(cfg, device="cpu", dropout_rate=0.3)
    dp = Trainer(cfg, device="cpu", dropout_rate=0.3, mesh=Mesh(["cpu"] * 8))
    ref_loss = float(one.train_step(a, n))
    out = {}
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=lambda: out.update(loss=float(dp.train_step(a, n))))
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not worker.is_alive() and "loss" in out
    assert_same_step(one, dp, ref_loss, out["loss"])
    assert all(int(v) == 1 for k, v in dp.model.state_dict().items() if "num_batches" in k)


def test_a_trainer_on_a_mesh_is_collected_and_its_threads_stop(tmp_path):
    """Once a 2-shard trainer has taken a step and is dropped, nothing holds
    it: the garbage collector takes it, and its shard threads exit."""
    import gc
    import threading
    import weakref

    def shard_threads():
        return {t for t in threading.enumerate() if t.name.startswith("train-shard-")}

    before = shard_threads()
    dp = Trainer(cfg_of(tmp_path, 4, freeze_backbone=False, loss="triplet"), device="cpu",
                 mesh=Mesh(["cpu"] * 2))
    mine = shard_threads() - before
    assert len(mine) == 2
    dp.train_step(spread_batch(40, 4), spread_batch(41, 4))
    gone = weakref.ref(dp)
    del dp
    gc.collect()
    assert gone() is None
    for t in mine:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in mine)


@pytest.mark.parametrize("fault", ["detached_statistics", "one_leaf_3_percent"])
def test_the_step_check_sees_a_planted_fault(tmp_path, monkeypatch, fault):
    """The leaf-by-leaf check fails on a faulty sharded step whose loss is
    right: the global BatchNorm statistics detached from the graph (no
    gradient through them), or one mid-network leaf's gradient 3% off."""
    from image_search_engine_tpu_torch.parallel import data_parallel
    from image_search_engine_tpu_torch.training.siamese import train

    cfg = cfg_of(tmp_path, 8, freeze_backbone=False, loss="self_supervised_circle")
    a, n = spread_batch(60, 8), spread_batch(61, 8)
    one = Trainer(cfg, device="cpu")
    dp = Trainer(cfg, device="cpu", mesh=Mesh(["cpu"] * 4))
    names = [k for k, _ in dp.model.named_parameters() if k.startswith("backbone")]
    leaf = names[len(names) // 2]
    if fault == "detached_statistics":
        combine = data_parallel._Rendezvous._combine

        def planted(self):
            combine(self)
            self._result = tuple(t.detach() for t in self._result)

        monkeypatch.setattr(data_parallel._Rendezvous, "_combine", planted)
    else:
        reduce = train.reduce_gradients

        def planted(replicas, mesh):
            reduce(replicas, mesh)
            for r in replicas:
                r.get_parameter(leaf).grad.mul_(1.03)

        monkeypatch.setattr(train, "reduce_gradients", planted)
    ref_loss, got_loss = float(one.train_step(a, n)), float(dp.train_step(a, n))
    gaps = leaf_gaps(one, dp, ref_loss, got_loss)
    assert gaps["loss"] <= 1.0
    over = over_bound(gaps)
    if fault == "detached_statistics":
        assert sum(k.startswith("trace:backbone") for k in over) > len(names) // 2, over
    else:
        assert f"trace:{leaf}" in over and not any(k.startswith("stats") for k in over), over
