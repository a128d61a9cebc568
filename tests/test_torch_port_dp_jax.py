"""The port's data-parallel train step against the JAX package's own
data-parallel program, on the CPU at tiny shapes: the JAX step with its
batch placed by ``NamedSharding(make_mesh(4), P("data"))`` and its state
replicated, as ``Trainer._shard_batch`` does, against
``Trainer(cfg, mesh=Mesh([cpu] * 4))`` from the same state, batch and draws,
at ``step_compare.STEP_BOUNDS`` (the bounds of tests/test_torch_port_siamese_train.py).
One case: the JAX program's compile takes most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_port_dp_train import DIM, SIZE, cfg_of, spread_batch
from test_torch_port_siamese_ops import jax_augment_params

from image_search_engine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_search_engine_tpu.training.siamese.augmentations import augment_batch
from image_search_engine_tpu.training.siamese.config import SiameseConfig as JaxConfig
from image_search_engine_tpu.training.siamese.model import EmbeddingNet as FlaxEmbeddingNet
from image_search_engine_tpu.training.siamese.model import apply_siamese as flax_apply_siamese
from image_search_engine_tpu.training.siamese.train import make_loss_fn as jax_loss_fn
from image_search_engine_tpu_torch.models.weights import state_dict_from_flax
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.training.siamese.step_compare import STEP_BOUNDS
from image_search_engine_tpu_torch.training.siamese.train import Trainer


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_four_shards_match_the_jax_data_parallel_step(tmp_path):
    """One step of the JAX package's program on its 4-device mesh (batch
    sharded over "data", params, batch_stats and the momentum trace
    replicated), unfrozen under the self-supervised circle loss, batch 4,
    dropout 0, against the port's 4-shard step from the same state, batch
    and draws (the inputs of tests/test_torch_port_siamese_unfrozen.py's
    first step)."""
    batch, lr = 4, 1e-4
    jmesh = jax_make_mesh(4)
    rep, data = NamedSharding(jmesh, P()), NamedSharding(jmesh, P("data"))
    model = FlaxEmbeddingNet(embedding_dim=DIM, dropout_rate=0.0, freeze_backbone=False,
                             backbone="densenet-tiny")
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=False))()
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(5)  # every statistic non-trivial
    stats = jax.tree_util.tree_map_with_path(lambda path, v: jnp.asarray(
        0.5 + rng.random(v.shape) if path[-1].key == "var"
        else 0.1 * rng.standard_normal(v.shape), jnp.float32), stats)
    tx = optax.sgd(lr, momentum=0.937)
    loss_fn = jax_loss_fn(JaxConfig(loss="self_supervised_circle", lr=lr))
    key = jax.random.PRNGKey(10)

    @jax.jit
    def step(params, stats, opt, a, n):
        def lossf(p):
            a32, n32 = a.astype(jnp.float32) / 255.0, n.astype(jnp.float32) / 255.0
            (ea, ep, en), upd = flax_apply_siamese(
                model, {"params": p, "batch_stats": stats}, (a32, augment_batch(key, a32), n32),
                train=True, rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
            return loss_fn(ea, ep, en), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(lossf, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss

    a, n = spread_batch(0, batch), spread_batch(1, batch)
    p0, s0, o0 = (jax.device_put(t, rep) for t in (params, stats, tx.init(params)))
    new_p, new_s, new_o, want = step(p0, s0, o0, jax.device_put(a, data),
                                     jax.device_put(n, data))
    assert np.isfinite(float(want))

    dp = Trainer(cfg_of(tmp_path, batch, freeze_backbone=False, loss="self_supervised_circle",
                        lr=lr),
                 device="cpu", dropout_rate=0.0, mesh=Mesh(["cpu"] * 4))
    dp.model.load_state_dict(state_dict_from_flax(params, stats, (2, 2), arch="siamese"),
                             strict=False)
    got = float(dp.train_step(a, n, aug_params=jax_augment_params(key, batch, SIZE, SIZE)))
    np.testing.assert_allclose(got, float(want), rtol=STEP_BOUNDS["loss_rtol"])
    state = state_dict_from_flax(new_p, new_s, (2, 2), arch="siamese")
    trace = state_dict_from_flax(new_o[0].trace, new_s, (2, 2), arch="siamese")
    names, mine = dict(dp.model.named_parameters()), dp.model.state_dict()
    floor = STEP_BOUNDS["trace_floor"] * max(float(trace[k].abs().max()) for k in names)
    for k, v in state.items():
        if "running" in k:
            np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=STEP_BOUNDS["stats_rtol"],
                                       atol=STEP_BOUNDS["stats_atol"], err_msg=k)
            continue
        np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=0,
                                   atol=STEP_BOUNDS["param_atol"], err_msg=k)
        leaf_max = float(trace[k].abs().max())
        atol = max(STEP_BOUNDS["trace_rtol"] * leaf_max, floor)
        assert atol <= 0.1 * leaf_max, (k, leaf_max, atol)
        np.testing.assert_allclose(dp.opt.state[names[k]]["momentum_buffer"].numpy(),
                                   trace[k].numpy(), rtol=0, atol=atol, err_msg=k)
