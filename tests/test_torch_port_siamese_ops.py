"""The port's siamese losses, augmentation, pair batches, card corpus and
checkpoint names against the JAX package's, on numpy-seeded inputs.

Tolerances: loss values and gradients atol 1e-5 against ``jax.grad``
(circle at the reference's scale of 256, on embeddings of norm 16 whose
similarities sit near the margins, so the logits stay within tens and the
gradients, which scale as 1 / norm, within a few units: atol 1e-5 is then
some ten f32 ulps of the largest); the augmentation
atol 1e-4 against ``augment_batch``, its draws derived from the JAX key by
the same ``jax.random`` calls. Where a source coordinate of the composed
resample lies within two ulps of an integer, the two packages' ulp-apart
coordinates may land on either side of an image edge (white against a
pixel): such pixels would be counted and left out; at the seeds below
there are none (the test asserts the count, 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.training.siamese import augmentations as jax_aug
from image_search_engine_tpu.training.siamese import losses as jax_losses
from image_search_engine_tpu.training.siamese.config import ckpt_filename as jax_ckpt_filename
from image_search_engine_tpu.training.siamese.dataset import PairsGenerator as JaxPairs
from image_search_engine_tpu.training.siamese.eval import (
    make_synthetic_card_corpus as jax_card_corpus)
from image_search_engine_tpu_torch.training.siamese import augmentations as aug
from image_search_engine_tpu_torch.training.siamese import losses
from image_search_engine_tpu_torch.training.siamese.config import (
    ckpt_filename, extract_epoch_and_loss, get_best_val_loss, get_latest_checkpoint)
from image_search_engine_tpu_torch.training.siamese.dataset import PairsGenerator
from image_search_engine_tpu_torch.training.siamese.eval import make_synthetic_card_corpus
from image_search_engine_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_pytree, load_tree_file, save_pytree, save_tree_file)

TOL = 1e-5
AUG_TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def loss_inputs(b=6, d=32, seed=0):
    """(anchor, positive, negative) of norm 16: positives at cosine ~0.75
    to their anchors, negatives ~0.25, so the circle logits at scale 256
    stay within tens."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, d))
    a /= np.linalg.norm(a, axis=1, keepdims=True)

    def mix(c):
        r = rng.standard_normal((b, d))
        r -= (r * a).sum(1, keepdims=True) * a
        r /= np.linalg.norm(r, axis=1, keepdims=True)
        return c * a + np.sqrt(1 - c * c) * r
    p = mix(0.75 + 0.05 * rng.standard_normal((b, 1)))
    n = mix(0.25 + 0.05 * rng.standard_normal((b, 1)))
    return [(16.0 * v).astype(np.float32) for v in (a, p, n)]


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_losses_and_gradients_match_jax(name):
    a, p, n = loss_inputs()
    jfn = jax_losses.LOSSES[name]
    want, jgrads = jax.jit(jax.value_and_grad(lambda *t: jfn(*t), argnums=(0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, p, n)]
    got = losses.LOSSES[name](*ts)
    got.backward()
    assert abs(float(want)) < 50  # the inputs keep the logits moderate
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=TOL)
    for t, g in zip(ts, jgrads):
        grad = np.zeros_like(a) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(g), rtol=0, atol=TOL)


def test_per_example_triplet_and_circle_margins_match_jax():
    a, p, n = loss_inputs(seed=1)
    np.testing.assert_allclose(
        losses.triplet_loss(*map(torch.from_numpy, (a, p, n)), margin=0.3).numpy(),
        np.asarray(jax.jit(jax_losses.triplet_loss)(a, p, n, margin=0.3)), rtol=0, atol=TOL)
    jcircle, jself = (jax.jit(f, static_argnums=(-2, -1)) for f in (
        lambda a, p, n, m, s: jax_losses.circle_loss(a, p, n, m, s),
        lambda a, p, m, s: jax_losses.self_supervised_circle_loss(a, p, m, s)))
    for m, s in ((0.1, 32.0), (0.4, 80.0)):
        np.testing.assert_allclose(
            losses.circle_loss(*map(torch.from_numpy, (a, p, n)), margin=m, scale=s).item(),
            float(jcircle(a, p, n, m, s)), rtol=0, atol=TOL)
        np.testing.assert_allclose(
            losses.self_supervised_circle_loss(torch.from_numpy(a), torch.from_numpy(p), m,
                                               s).item(),
            float(jself(a, p, m, s)), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


def jax_augment_params(key, b: int, h: int, w: int) -> dict:
    """The draws of the JAX ``augment_batch(key, images)`` of a (b, h, w, 3)
    batch, by its own ``jax.random`` calls, in the port's layout
    (``augmentations.sample_params``)."""
    return {k: ({n: _tensor(g) for n, g in v.items()} if k == "gates" else _tensor(v))
            for k, v in _draws(key, b, h, w).items()}


def _tensor(a):
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _draws(key, b, h, w):
    r = jax.random
    keys = r.split(key, 16)

    def uni(k, lo, hi, shape=(b,)):
        return r.uniform(k, shape, minval=lo, maxval=hi).reshape(b)

    out = {"gates": jax_aug.sample_gates(key, b),
           "bright": uni(keys[0], -0.2, 0.2, (b, 1, 1, 1)),
           "contrast": uni(keys[1], 0.8, 1.2, (b, 1, 1, 1)),
           "gamma": uni(keys[2], 0.6, 1.2, (b, 1, 1, 1)),
           "hue": uni(keys[3], -15.0, 15.0, (b, 1, 1)),
           "sat": uni(keys[4], 0.85, 1.15, (b, 1, 1)),
           "noise_sigma": uni(keys[5], 0.0, 0.03, (b, 1, 1, 1)),
           "noise": r.normal(keys[6], (b, h, w, 3)),
           "drop": r.bernoulli(keys[7], 0.01, (b, h, w, 1))[..., 0],
           "blur5": r.bernoulli(keys[8], 0.5, (b, 1, 1, 1)).reshape(b),
           "hole_y": r.randint(keys[9], (b, 1, 1), 0, h).reshape(b),
           "hole_x": r.randint(keys[10], (b, 1, 1), 0, w).reshape(b),
           "distort": uni(keys[13], -0.05, 0.05)}
    kp1, kp2 = r.split(keys[12])
    out["persp_y"], out["persp_x"] = uni(kp1, -0.1, 0.1), uni(kp2, -0.1, 0.1)
    per_image = jax.vmap(lambda k: r.split(k, 4))(r.split(keys[11], b))  # (b, 4) keys
    for name, j, lo, hi in (("scale", 0, 0.9, 1.0), ("rot", 1, -1.0, 1.0),
                            ("shift_y", 2, -0.05, 0.05), ("shift_x", 3, -0.05, 0.05)):
        out[name] = jax.vmap(lambda k: r.uniform(k, (), minval=lo, maxval=hi))(
            per_image[:, j])
    return out


def near_integer(params, b, h, w) -> np.ndarray:
    """(b, h, w) mask of pixels whose composed source coordinate lies within
    two ulps of an integer (where the geometric family fires)."""
    sy, sx = aug.source_grid(params, b, h, w, "cpu")
    near = torch.zeros((b, h, w), dtype=torch.bool)
    for s in (sy, sx):
        ulp = torch.clamp(s.abs(), min=1.0) * float(np.finfo(np.float32).eps)
        near |= (s - torch.round(s)).abs() <= 2 * ulp
    geo = torch.stack([params["gates"][n] for n in ("zoom_out", "shift", "safe_rotate",
                                                    "perspective", "optical_distortion")]).any(0)
    return (near & geo[:, None, None]).numpy()


@pytest.fixture(scope="module")
def jax_all_on():
    """The JAX ``augment_batch`` with every gate on, compiled once: traced
    while ``sample_gates`` answers all-true (jit's cache of the module's own
    function holds the real gates)."""
    ones = {n: jnp.ones((8,), bool) for n in jax_aug.OP_PROBS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_aug, "sample_gates", lambda k, n: ones)
        return jax.jit(lambda k, x: jax_aug.augment_batch.__wrapped__(k, x)).lower(
            jax.random.PRNGKey(0), jnp.zeros((8, 36, 28, 3), jnp.float32)).compile()


@pytest.mark.parametrize("seed,all_on", [(0, False), (1, False), (2, True), (3, True)])
def test_apply_matches_jax_augment_batch(seed, all_on, jax_all_on):
    """Gated as the key draws (32 x 32), then every op on every image (36 x
    28: height and width apart)."""
    b, (h, w) = 8, ((36, 28) if all_on else (32, 32))
    key = jax.random.PRNGKey(seed)
    images = np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)
    params = jax_augment_params(key, b, h, w)
    if all_on:
        params["gates"] = {n: torch.ones(b, dtype=torch.bool) for n in params["gates"]}
        want = np.asarray(jax_all_on(key, jnp.asarray(images)))
    else:
        want = np.asarray(jax_aug.augment_batch(key, jnp.asarray(images)))
    got = aug.apply(torch.from_numpy(images), params).numpy()
    skip = near_integer(params, b, h, w)
    assert skip.sum() == 0, skip.sum()  # the count at these seeds
    diff = np.abs(got - want).max(-1)
    assert diff[~skip].max() <= AUG_TOL, diff[~skip].max()


def test_all_gates_off_is_identity_and_each_op_alone_changes_the_image():
    b, h, w = 4, 32, 32
    gen = torch.Generator().manual_seed(0)
    images = torch.rand((b, h, w, 3), generator=gen) * 0.8 + 0.1
    params = aug.sample_params(gen, b, h, w)
    off = {n: torch.zeros(b, dtype=torch.bool) for n in aug.OP_PROBS}
    assert torch.equal(aug.apply(images, {**params, "gates": off}), images)
    for name in aug.OP_PROBS:
        one = {**off, name: torch.ones(b, dtype=torch.bool)}
        out = aug.apply(images, {**params, "gates": one})
        assert out.shape == images.shape and out.min() >= 0 and out.max() <= 1
        assert (out - images).abs().amax(dim=(1, 2, 3)).min() > 1e-3, name


def test_gate_frequencies_track_op_probs():
    params = aug.sample_params(torch.Generator().manual_seed(1), 20_000, 2, 2)
    for name, p in aug.OP_PROBS.items():
        assert abs(params["gates"][name].float().mean().item() - p) < 0.015, name
    for name, (lo, hi) in aug.RANGES.items():
        v = params[name]
        assert lo <= v.min() and v.max() <= hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert abs(params["drop"].float().mean().item() - 0.01) < 0.003


# ---------------------------------------------------------------------------
# pair batches, the card corpus, checkpoint names
# ---------------------------------------------------------------------------


def test_pairs_generator_yields_the_jax_batches(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(7):
        img = (rng.random((20, 16, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"c{i}.png")
    port, jaxg = (iter(cls.from_dir(tmp_path, 3, (24, 20), seed=5))
                  for cls in (PairsGenerator, JaxPairs))
    for _ in range(4):
        (pa, pn), (ja, jn) = next(port), next(jaxg)
        assert pa.dtype == np.uint8 and pa.shape == (3, 24, 20, 3)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pn, jn)
    assert PairsGenerator.from_dir(tmp_path, 3, (24, 20)).steps_per_epoch() == 2


def test_card_corpus_cards_equal_the_jax_ones():
    # (8, 32, 32, 3) query batches: the augmentation test's compiled shape
    cards, queries, qlabel = make_synthetic_card_corpus(3, 32, q_per=8)
    jcards, jqueries, jqlabel = jax_card_corpus(3, 32, q_per=8)
    np.testing.assert_array_equal(cards, jcards)
    np.testing.assert_array_equal(qlabel, jqlabel)
    assert queries.shape == jqueries.shape and queries.dtype == np.float32
    assert 0 <= queries.min() and queries.max() <= 1
    assert not np.array_equal(queries[0], cards[0])


def test_checkpoint_names(tmp_path):
    name = ckpt_filename(7, 0.1234)
    assert name == "epoch_07-loss_0.1234.pt"
    assert name.removesuffix(".pt") == jax_ckpt_filename(7, 0.1234).removesuffix(".msgpack")
    assert extract_epoch_and_loss(name) == (7, 0.1234)
    assert extract_epoch_and_loss(jax_ckpt_filename(7, 0.1234)) is None  # flax msgpack
    for e, v in ((1, 0.5), (3, 0.4), (2, 0.3)):
        (tmp_path / ckpt_filename(e, v)).write_bytes(b"x")
    (tmp_path / jax_ckpt_filename(9, 0.1)).write_bytes(b"x")
    assert get_latest_checkpoint(tmp_path).name == ckpt_filename(3, 0.4)
    assert get_best_val_loss(tmp_path) == 0.3
    assert get_latest_checkpoint(tmp_path / "none") is None
    assert get_best_val_loss(tmp_path / "none") == float("inf")


def test_pytree_checkpoints_and_retention(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "steps": [torch.tensor(3), 4.5],
            "inner": {"b": torch.ones(2, dtype=torch.bfloat16)}}
    save_pytree(tmp_path / "one", tree)
    back = load_pytree(tmp_path / "one")
    assert torch.equal(back["w"], tree["w"]) and back["steps"][1] == 4.5
    with pytest.raises(FileExistsError):
        save_pytree(tmp_path / "one", tree, force=False)
    target = {**tree, "w": torch.zeros(2, 3, dtype=torch.float64)}
    assert load_pytree(tmp_path / "one", target)["w"].dtype == torch.float64
    with pytest.raises(ValueError):
        load_pytree(tmp_path / "one", {**tree, "w": torch.zeros(3, 2)})
    save_tree_file(tmp_path / "one.pt", tree)  # the trainer's epoch files
    assert sorted(p.name for p in tmp_path.glob("one.pt*")) == ["one.pt"]
    assert load_tree_file(tmp_path / "one.pt", target)["w"].dtype == torch.float64
    mgr = CheckpointManager(tmp_path / "mgr", max_to_keep=2)
    assert mgr.latest_step is None
    for step in (1, 5, 9):
        mgr.save(step, {"step": torch.tensor(step)})
    assert mgr.steps() == [5, 9] and mgr.latest_step == 9
    assert mgr.restore()["step"].item() == 9 and mgr.restore(5)["step"].item() == 5
    mgr.close()


def test_batchnorm_two_pass_variance_beside_flax_one_pass():
    """Over columns nearly constant across the batch (12 rows of mean 5,
    spread 1e-2), Flax's one-pass variance (E[x^2] - E[x]^2 in f32) loses
    the digits torch's two-pass variance keeps: against float64, the port's
    BatchNorm output is within 5.0e-5 (the f32 rounding of x, over a std of
    1e-2) and Flax's off by 0.24. This is why the train-step tests hold each
    step to the JAX package's from the JAX state, on batches whose images
    differ in brightness."""
    import flax.linen as fnn

    from image_search_engine_tpu_torch.models.layers import BatchNorm1d

    x = (5.0 + 1e-2 * np.random.default_rng(11).standard_normal((12, 64))).astype(np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(0)) / np.sqrt(x64.var(0) + 1e-5)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    flax_out = np.asarray(jax.jit(lambda v, t: fbn.apply(v, t, mutable=["batch_stats"])[0])(
        fbn.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    port_out = BatchNorm1d(64).train()(torch.from_numpy(x)).detach().numpy()
    port_err, flax_err = np.abs(port_out - want).max(), np.abs(flax_out - want).max()
    assert port_err < 1e-4 and flax_err > 100 * port_err, (port_err, flax_err)
