"""The port's preprocessing, ResNet, weight bridge and embedder against the
JAX package's on the same numpy-seeded inputs and weights.

Tolerances: f32 forward rtol = atol = 2e-4 (what tests/test_torch_import.py
holds the Flax model to against torch: different conv algorithms sum in
different orders). The default bf16 embedder: per-row relative L2 error
<= 3e-2 against the f32 Flax model (bf16 keeps 8 mantissa bits; activations
round at every layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.models.embedder import CNNEmbedder as JaxEmbedder
from image_search_engine_tpu.models.resnet import ResNet18Thin as FlaxResNet18Thin
from image_search_engine_tpu.models.torch_import import convert_torchvision_resnet
from image_search_engine_tpu.ops import image_ops as jax_image_ops
from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
from image_search_engine_tpu_torch.models.resnet import ResNet, ResNet18Thin, ResNet50
from image_search_engine_tpu_torch.models.weights import (
    load_torch_weights, state_dict_from_flax)
from image_search_engine_tpu_torch.ops import image_ops

TINY = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flax_vars():
    """resnet-tiny Flax variables (numpy trees) with seeded lecun-normal
    convs and every BN made non-trivial (random scale, bias, running mean
    and variance), so no block is an identity."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in ResNet18Thin().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = tuple(v.shape)
        if v.dim() == 4:
            a = rng.standard_normal(shape) * (1.0 / np.prod(shape[1:])) ** 0.5
        elif k.endswith("weight"):
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif k.endswith(("bias", "running_mean")):
            a = 0.1 * rng.standard_normal(shape)
        else:  # running_var
            a = 0.5 + rng.random(shape)
        sd[k] = a.astype(np.float32)
    return convert_torchvision_resnet(sd, TINY)


def _images(n=3, size=32, seed=1):
    return (np.random.default_rng(seed).random((n, size, size, 3)) * 255).astype(np.uint8)


def test_resnet_tiny_forward_matches_flax(flax_vars):
    params, stats = flax_vars
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    # jit: one XLA compile instead of one per primitive in eager mode
    want = np.asarray(jax.jit(FlaxResNet18Thin().apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = ResNet18Thin()
    model.load_state_dict(state_dict_from_flax(params, stats, TINY), strict=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_f32_embeddings(flax_vars):
    params, stats = flax_vars
    return JaxEmbedder("resnet-tiny", image_size=32, batch_size=2, dtype=jnp.float32,
                       params=params, batch_stats=stats).embed_batch(_images())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
def test_embedder_matches_jax_f32(flax_vars, jax_f32_embeddings, dtype, tol):
    params, stats = flax_vars
    imgs = _images()
    want = jax_f32_embeddings
    got = CNNEmbedder("resnet-tiny", image_size=32, batch_size=2, dtype=dtype, device="cpu",
                      state_dict=state_dict_from_flax(params, stats, TINY)).embed_batch(imgs)
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert got.dtype == np.float32 and got.shape == (3, 2048)
    assert rel.max() <= tol, rel


def test_bridge_round_trips_a_torchvision_state_dict():
    # torchvision layout -> JAX converter -> port bridge -> the same tensors
    model = ResNet50(generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.normal_()
                m.running_var.uniform_(0.5, 1.5)
    sd = model.state_dict()
    params, stats = convert_torchvision_resnet(sd, (3, 4, 6, 3))
    back = state_dict_from_flax(params, stats, (3, 4, 6, 3))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_torch_weights_file_loads_straight_in(tmp_path):
    src = ResNet18Thin(generator=torch.Generator().manual_seed(4))
    p = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.state_dict().items()}}, p)
    dst = ResNet18Thin()
    load_torch_weights(dst, p)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    # a deeper checkpoint (two blocks in the first stage) must not half-load
    torch.save(ResNet((2, 1, 1, 1)).state_dict(), tmp_path / "deep.pth")
    with pytest.raises(ValueError, match="does not match"):
        load_torch_weights(ResNet18Thin(), tmp_path / "deep.pth")


@pytest.mark.parametrize("size,out", [(32, 32), (64, 32), (50, 24)])
def test_preprocess_for_cnn_matches_jax(size, out):
    # identity at the build size; antialiased bilinear when downsampling
    img = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_image_ops.preprocess_for_cnn(jnp.asarray(img), out))
    got = image_ops.preprocess_for_cnn(torch.from_numpy(img), out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(image_ops.to_unit_f32(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jax_image_ops.to_unit_f32(jnp.asarray(u8))))


def test_random_init_mirrors_flax():
    model = ResNet18Thin(generator=torch.Generator().manual_seed(0))
    conv = model.layer1[0].conv2.weight
    assert abs(conv.std().item() - (1 / (64 * 9)) ** 0.5) < 0.01
    assert all((blk.bn3.weight == 0).all() for layer in (model.layer1, model.layer4) for blk in layer)
    assert model.layer1[0].bn1.eps == 1e-5


def test_embedder_arch_tag_matches_jax():
    from image_search_engine_tpu.indexer import EMBEDDER_ARCH as JAX_ARCH
    from image_search_engine_tpu_torch.indexer import EMBEDDER_ARCH

    assert EMBEDDER_ARCH == JAX_ARCH


def test_unported_backbones_raise():
    # every backbone of the JAX registry is ported (its dim and input
    # normalization too); only a name outside it raises
    from image_search_engine_tpu.models.embedder import MODEL_REGISTRY as JAX_REGISTRY
    from image_search_engine_tpu_torch.models.embedder import MODEL_REGISTRY

    assert ({k: v[1:] for k, v in MODEL_REGISTRY.items()}
            == {k: v[1:] for k, v in JAX_REGISTRY.items()})
    with pytest.raises(ValueError, match="unknown model"):
        CNNEmbedder("bit-101", device="cpu")
