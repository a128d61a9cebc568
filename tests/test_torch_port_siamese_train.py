"""The port's siamese train step against the JAX package's, on the CPU at
tiny shapes (the training loop, index building, evaluation and serving:
tests/test_torch_port_siamese_loop.py).

Three SGD steps of ``densenet-tiny`` at 32 px, batch 4, f32, dropout 0, lr
1e-4, frozen (circle loss) and unfrozen (triplet), with the same weights
(carried across by ``state_dict_from_flax``), the same uint8 batches and
the same augmentation draws (derived from the JAX key): the JAX side is
``EmbeddingNet(dropout_rate=0.0)`` under ``jax.value_and_grad`` and
``optax.sgd``, driven here. Each step starts from the JAX state after the
one before. Tolerances, at every step: the loss rtol 1e-5; parameters atol
1e-5; every ``batch_stats`` leaf rtol 1e-5 (with atol 1e-6 for running
means near 0; torch's own BatchNorm would be off by n / (n - 1), 12 / 11 at
the head); the momentum trace, which holds raw gradients, leaf by leaf
within TRACE_RTOL of that leaf's largest entry, or TRACE_FLOOR of the
net's largest where that is larger. The floor serves the stem
BatchNorm's scale, whose gradient is a cancellation: at the first
unfrozen step its largest entry is 0.0197 against 1,577 over the net, and
it is off by 9.2e-4 (4.7e-2 of it; then 6.6e-4 and 3.8e-4 of it), where
the JAX package itself moves by 2.0e-2 of it when its initial weights are
perturbed at f32 rounding. Every leaf's bound stays under a tenth of its
largest entry, so a wrong gradient in any leaf fails. Every other leaf
is off by at most 7.1e-5 of its largest entry.
Then the same three steps run free from the initial state, their losses
held to the JAX package's at FREE_RTOL per step: both packages amplify
rounding step by step through the 12-row BatchNorms and the circle loss's
scale of 256 (unfrozen, the port is off by 2.8e-6, 9.1e-5 and 2.8e-3 of
the loss; the JAX package against itself with its initial weights
perturbed by 6e-8, relative, by 6.6e-8, 7.7e-5 and 2.7e-3). The bf16 loss
within 5% of the f32 one, the JAX package's bar, on the same batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from test_torch_port_siamese_ops import jax_augment_params

from image_search_engine_tpu.training.siamese.augmentations import augment_batch
from image_search_engine_tpu.training.siamese.config import SiameseConfig as JaxConfig
from image_search_engine_tpu.training.siamese.model import EmbeddingNet as FlaxEmbeddingNet
from image_search_engine_tpu.training.siamese.model import apply_siamese as flax_apply_siamese
from image_search_engine_tpu.training.siamese.train import make_loss_fn as jax_loss_fn
from image_search_engine_tpu_torch.models.weights import state_dict_from_flax
from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
from image_search_engine_tpu_torch.training.siamese.train import Trainer

TINY = (2, 2)
B, SIZE, DIM = 4, 32, 8
TRACE_RTOL = 2e-4  # of each momentum-trace leaf's largest entry
TRACE_FLOOR = 1e-6  # of the trace's largest entry over the net
FREE_RTOL = (1e-5, 1e-3, 1e-2)  # the free-running losses, step by step


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
# three SGD steps against the JAX package's
# ---------------------------------------------------------------------------


def jax_steps(frozen: bool, loss: str, lr: float, batches, keys):
    """Three steps of the JAX net, driven here. Returns the variables at
    init, then per step its loss and the params, momentum trace and
    batch_stats after it."""
    cfg = JaxConfig(loss=loss, lr=lr)
    model = FlaxEmbeddingNet(embedding_dim=DIM, dropout_rate=0.0, freeze_backbone=frozen,
                             backbone="densenet-tiny")
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=False))()
    params, stats = variables["params"], variables["batch_stats"]
    # every BN's statistics non-trivial, so the eval-mode ones matter
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map_with_path(lambda path, a: jnp.asarray(
        0.5 + rng.random(a.shape) if path[-1].key == "var" else 0.1 * rng.standard_normal(a.shape),
        jnp.float32), stats)
    tx = optax.sgd(lr, momentum=0.937)
    opt = tx.init(params)
    loss_fn = jax_loss_fn(cfg)

    @jax.jit
    def step(params, stats, opt, key, a, n):
        def lossf(p):
            a32, n32 = a.astype(jnp.float32) / 255.0, n.astype(jnp.float32) / 255.0
            pos = augment_batch(key, a32)
            (ea, ep, en), upd = flax_apply_siamese(
                model, {"params": p, "batch_stats": stats}, (a32, pos, n32), train=True,
                rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
            return loss_fn(ea, ep, en), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(lossf, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss

    init, steps = (params, stats), []
    for (a, n), key in zip(batches, keys):
        params, stats, opt, loss = step(params, stats, opt, key, a, n)
        steps.append((float(loss), params, opt[0].trace, stats))
    return init, steps


def spread_batch(seed: int) -> np.ndarray:
    """(B, SIZE, SIZE, 3) uint8 smooth colour fields, each at its own
    brightness (x 0.1 to 1): the head's BatchNorm columns then spread over
    the batch. Over near-constant columns Flax's one-pass variance
    (E[x^2] - E[x]^2) loses the digits the comparison needs."""
    from PIL import Image as _Image

    rng = np.random.default_rng(seed)
    out = []
    for scale in np.linspace(0.1, 1.0, B)[rng.permutation(B)]:
        low = (rng.random((6, 6, 3)) * 255 * scale).astype(np.uint8)
        out.append(np.asarray(_Image.fromarray(low).resize((SIZE, SIZE), _Image.BILINEAR)))
    return np.stack(out)


def port_state(params, stats):
    return state_dict_from_flax(params, stats, TINY, arch="siamese")


def test_three_sgd_steps_match_jax(cards, frozen=True, loss="circle"):
    """A frozen backbone under the circle loss (the unfrozen backbone:
    tests/test_torch_port_siamese_unfrozen.py). Each step starts from the
    JAX package's state after the one before
    (params, batch_stats and momentum trace carried across), so every step
    is held to f32 rounding: free-running, the BatchNorms over 12 rows
    amplify the two packages' rounding step by step, and Flax's one-pass
    variance loses digits over near-constant columns
    (tests/test_torch_port_siamese_ops.py::
    test_batchnorm_two_pass_variance_beside_flax_one_pass)."""
    lr = 1e-4  # the reference's
    batches = [(spread_batch(2 * i), spread_batch(2 * i + 1)) for i in range(3)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    (p0, s0), steps = jax_steps(frozen, loss, lr, batches, keys)

    tr = Trainer(tiny_cfg(cards, loss=loss, lr=lr, freeze_backbone=frozen,
                          compute_dtype="f32"), device="cpu", dropout_rate=0.0)
    names = dict(tr.model.named_parameters())
    state, trace = port_state(p0, s0), None
    for (a, n), key, (want_loss, params, want_trace, stats) in zip(batches, keys, steps):
        tr.model.load_state_dict(state, strict=False)
        if trace is not None:  # optax's trace is torch's momentum buffer
            for k, p in names.items():
                if k in trace and tr.opt.state.get(p):
                    tr.opt.state[p]["momentum_buffer"].copy_(trace[k])
        got_loss = float(tr.train_step(a, n, aug_params=jax_augment_params(key, B, SIZE, SIZE)))
        assert np.isfinite(want_loss)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        state, trace = port_state(params, stats), port_state(want_trace, stats)
        # the trace holds gradients: each leaf held to its own scale
        floor = TRACE_FLOOR * max(float(trace[k].abs().max()) for k in names)
        got = tr.model.state_dict()
        assert set(names) | {k for k in got if "running" in k or "num_batches" in k} == set(got)
        for k, v in state.items():
            if "running" in k:  # batch_stats; means near 0 are held to 1e-6 absolute
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)
                continue
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
            buf = tr.opt.state.get(names[k], {}).get("momentum_buffer")
            if buf is None:  # frozen: no gradient
                assert not trace[k].any(), k
                continue
            leaf_max = float(trace[k].abs().max())
            atol = max(TRACE_RTOL * leaf_max, floor)
            assert atol <= 0.1 * leaf_max, (k, leaf_max, atol)
            np.testing.assert_allclose(buf.numpy(), trace[k].numpy(), rtol=0, atol=atol,
                                       err_msg=k)
    start = port_state(p0, s0)
    moved = [k for k in state if not torch.equal(state[k], start[k])]
    # a frozen backbone keeps its weights and statistics; the head always trains
    assert any(k.startswith("fc") for k in moved)
    assert any(k.startswith("backbone") for k in moved) is (not frozen)

    # the same three steps running free from the initial state
    tr = Trainer(tiny_cfg(cards, loss=loss, lr=lr, freeze_backbone=frozen,
                          compute_dtype="f32"), device="cpu", dropout_rate=0.0)
    tr.model.load_state_dict(port_state(p0, s0), strict=False)
    for (a, n), key, (want_loss, *_), rtol in zip(batches, keys, steps, FREE_RTOL):
        got_loss = float(tr.train_step(a, n, aug_params=jax_augment_params(key, B, SIZE, SIZE)))
        np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)


def test_bf16_loss_tracks_f32_and_state_stays_f32(cards):
    a, n = spread_batch(0), spread_batch(1)
    params = jax_augment_params(jax.random.PRNGKey(0), B, SIZE, SIZE)
    losses = {}
    for cd in ("bf16", "f32"):
        tr = Trainer(tiny_cfg(cards, loss="triplet", compute_dtype=cd), device="cpu")
        loss = tr.train_step(a, n, aug_params=params)
        assert loss.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
        assert all(s["momentum_buffer"].dtype == torch.float32 for s in tr.opt.state.values())
        losses[cd] = float(loss)
    assert np.isfinite(losses["bf16"]) and np.isfinite(losses["f32"])
    assert abs(losses["bf16"] - losses["f32"]) < 0.05 * (abs(losses["f32"]) + 1.0)
    with pytest.raises(ValueError, match="compute_dtype"):
        SiameseConfig(compute_dtype="fp16")


def test_uint8_embed_equals_f32_embed(cards):
    tr = Trainer(tiny_cfg(cards), device="cpu")
    u8 = np.random.default_rng(3).integers(0, 256, (5, SIZE, SIZE, 3), dtype=np.uint8)
    a = tr.embed(u8, batch_size=2)
    b = tr.embed(u8.astype(np.float32) / np.float32(255.0), batch_size=4)
    assert a.shape == (5, DIM) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_frozen_backbone_stays_in_eval_mode(cards):
    tr = Trainer(tiny_cfg(cards, freeze_backbone=True), device="cpu")
    tr.model.train()
    assert tr.model.training and not tr.model.backbone.training
    assert all(not m.training for m in tr.model.backbone.modules())
    assert tr.model.bn0.training


def test_random_init_matches_the_flax_init():
    """The port's random init draws from the Flax modules' distributions
    (``lecun_normal`` kernels, zero biases, unit BatchNorm scales): each
    random leaf of 512 entries or more has the Flax leaf's standard
    deviation within 10% and a mean near 0, and every constant leaf (biases,
    BatchNorm scales and statistics) equals the Flax one (the ratios read
    0.985 to 1.039 over the 14 random leaves). So a training run from the
    port's random init starts from the JAX package's distribution."""
    from image_search_engine_tpu_torch.training.siamese.model import EmbeddingNet

    model = FlaxEmbeddingNet(embedding_dim=DIM, backbone="densenet-tiny", freeze_backbone=False)
    flax_vars = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=False))()
    want = port_state(flax_vars["params"], flax_vars["batch_stats"])
    got = EmbeddingNet(embedding_dim=DIM, backbone="densenet-tiny",
                       generator=torch.Generator().manual_seed(0)).state_dict()
    assert set(got) >= set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if float(v.std()) > 0:
            assert v.numel() >= 512, k
            ratio = float(got[k].std() / v.std())
            assert abs(ratio - 1.0) < 0.1, (k, ratio)
            assert abs(float(got[k].mean())) < 4 * float(v.std()) / v.numel() ** 0.5, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
