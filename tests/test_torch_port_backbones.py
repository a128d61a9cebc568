"""The port's DenseNet and BiT backbones against the JAX package's, with the
same weights carried across, on numpy-seeded inputs.

Weights are random state dicts made with numpy under the names the JAX
package's importers read (torchvision's for DenseNet, HuggingFace
``BitModel``'s for BiT, with a ``bit.`` prefix, a classifier and
``pooler.*`` keys to drop), so one file drives both packages. Tolerance:
f32 forwards within atol 1e-4 (both sum the convolutions in f32, in other
orders). BiT runs at 33 and 64 px, where the TF-SAME padding of its
stride-2 convs and of the stem pool is asymmetric.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu.indexer import main as jax_indexer_main
from image_search_engine_tpu.models.bit import BiT as FlaxBiT, BiT50 as FlaxBiT50
from image_search_engine_tpu.models.densenet import (
    DenseNet as FlaxDenseNet, DenseNet121 as FlaxDenseNet121)
from image_search_engine_tpu.models.embedder import CNNEmbedder as JaxEmbedder
from image_search_engine_tpu.models.torch_import import (
    convert_hf_bit, convert_torchvision_densenet)
from image_search_engine_tpu.ops import image_ops as jax_image_ops
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.models import layers
from image_search_engine_tpu_torch.models.bit import BiT, BiT50, BiTTiny, same_pad
from image_search_engine_tpu_torch.models.densenet import DenseNet121, DenseNetTiny
from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
from image_search_engine_tpu_torch.models.weights import load_state_dict, state_dict_from_flax
from image_search_engine_tpu_torch.ops import image_ops
from image_search_engine_tpu_torch.utils.imageio import load_image, load_paths_csv

TOL = 1e-4
DENSE_TINY = (2, 2)
BIT_TINY = (1, 1)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """numpy arrays under ``model``'s parameter names: fan-in-scaled convs,
    every norm non-trivial (random scale, bias, running mean and var)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
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
    return sd


def hf_bit_layout(sd: dict) -> dict:
    """``BitForImageClassification``'s file: ``bit.``-prefixed backbone keys
    plus a classifier and pooler keys, which both packages drop."""
    out = {f"bit.{k}": v for k, v in sd.items()}
    out["classifier.1.weight"] = np.zeros((10, 4), np.float32)
    out["bit.pooler.weight"] = np.zeros((1,), np.float32)
    return out


def as_torch(sd: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def densenet_sd():
    return random_state_dict(DenseNetTiny(), 0)


@pytest.fixture(scope="module")
def bit_sd():
    return random_state_dict(BiTTiny(), 1)


def _port(model, sd):
    load_state_dict(model, as_torch(sd))
    return model.eval()


@pytest.mark.parametrize("size", [32, 64])
def test_densenet_tiny_matches_flax(densenet_sd, size):
    params, stats = convert_torchvision_densenet(densenet_sd, DENSE_TINY)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(FlaxDenseNet(block_sizes=DENSE_TINY, growth_rate=8).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(DenseNetTiny(), densenet_sd)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the Flax tree carried back is the torchvision state dict, tensor for tensor
    back = state_dict_from_flax(params, stats, DENSE_TINY, arch="densenet")
    assert set(back) == set(densenet_sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), densenet_sd[k], err_msg=k)


@pytest.mark.parametrize("size", [33, 64])
@pytest.mark.parametrize("pooling", ["avg", "flatten"])
def test_bit_tiny_matches_flax(bit_sd, size, pooling):
    params, stats = convert_hf_bit(hf_bit_layout(bit_sd), BIT_TINY)
    assert stats is None
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(FlaxBiT(stage_sizes=BIT_TINY, pooling=pooling).apply)(
        {"params": params}, jnp.asarray(x)))
    port = BiT(BIT_TINY, pooling=pooling)
    load_state_dict(port, as_torch(hf_bit_layout(bit_sd)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    back = state_dict_from_flax(params, None, BIT_TINY, arch="bit")
    assert set(back) == set(bit_sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), bit_sd[k], err_msg=k)


def test_bit_stem_pool_pads_zeros(bit_sd):
    """At 33 px the stem's 17 x 17 map is padded by one on each side, and
    some border windows hold only negative activations: there the zero pad
    sets the max (0), where a -inf pad would give a negative value."""
    model = _port(BiTTiny(), bit_sd)
    x = np.random.default_rng(33).uniform(-1, 1, (2, 33, 33, 3)).astype(np.float32)
    with torch.no_grad():
        stem = model.embedder["convolution"](torch.from_numpy(x).permute(0, 3, 1, 2))
        assert tuple(same_pad(stem, 3, 2).shape[2:]) == (19, 19)
        zero = torch.nn.functional.max_pool2d(same_pad(stem, 3, 2), 3, stride=2)
        neg_inf = torch.nn.functional.max_pool2d(stem, 3, stride=2, padding=1)
    assert zero.shape == neg_inf.shape
    assert ((zero == 0) & (neg_inf < 0)).any()
    # the windows that reach the pad are the first and last rows and columns
    border = torch.zeros(zero.shape[2:], dtype=torch.bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    assert torch.equal(zero, torch.where(border, neg_inf.clamp(min=0), neg_inf))


def test_full_size_trees_cross_both_ways():
    """DenseNet-121 and BiT-50: the port's parameter names are the files'
    the JAX importers read (every key consumed), and the converted trees
    have the Flax models' shapes."""
    for port, convert, flax_model, x in (
            (DenseNet121(), lambda sd: convert_torchvision_densenet(sd, (6, 12, 24, 16)),
             FlaxDenseNet121(), jnp.zeros((1, 64, 64, 3))),
            (BiT50(), lambda sd: convert_hf_bit(hf_bit_layout(sd)), FlaxBiT50(),
             jnp.zeros((1, 64, 64, 3)))):
        sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in port.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        params, stats = convert(sd)
        want = jax.eval_shape(lambda: flax_model.init(jax.random.PRNGKey(0), x))
        shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
        assert shapes(params) == shapes(want["params"])
        if stats is not None:
            assert shapes(stats) == shapes(want["batch_stats"])


@pytest.mark.parametrize("model_name", ["densenet-tiny", "bit-tiny"])
def test_torch_weights_file_gives_the_jax_embeddings(tmp_path, densenet_sd, bit_sd, model_name):
    sd = densenet_sd if model_name == "densenet-tiny" else hf_bit_layout(bit_sd)
    path = tmp_path / "w.pth"
    torch.save({"state_dict": as_torch(sd)}, path)
    imgs = (np.random.default_rng(4).random((3, 40, 40, 3)) * 255).astype(np.uint8)
    want = JaxEmbedder(model_name, image_size=33, batch_size=2, dtype=jnp.float32,
                       torch_weights=path).embed_batch(imgs)
    got = CNNEmbedder(model_name, image_size=33, batch_size=2, dtype=torch.float32,
                      device="cpu", torch_weights=path).embed_batch(imgs)
    assert got.shape == want.shape == (3, 32 if model_name == "densenet-tiny" else 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("norm", ["imagenet", "unit"])
def test_preprocess_norm_matches_jax(norm):
    img = np.random.default_rng(7).random((2, 40, 40, 3)).astype(np.float32)
    want = np.asarray(jax_image_ops.preprocess_for_cnn(jnp.asarray(img), 32, norm=norm))
    got = image_ops.preprocess_for_cnn(torch.from_numpy(img), 32, norm=norm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="norm"):
        image_ops.preprocess_for_cnn(torch.from_numpy(img), 32, norm="bit")


def test_batchnorm_keeps_flax_running_statistics():
    """One training step of the port's BatchNorm1d on 12 rows updates the
    running mean and variance as Flax's BatchNorm (momentum 0.9) does; torch's
    own layer folds in the unbiased variance, 12 / 11 of it."""
    import flax.linen as fnn

    x = np.random.default_rng(8).standard_normal((12, 5)).astype(np.float32) * 3 + 1
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = layers.BatchNorm1d(5).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=1e-6)
    plain = torch.nn.BatchNorm1d(5).train()
    plain(torch.from_numpy(x))
    ratio = (plain.running_var - 0.9) / (bn.running_var - 0.9)
    np.testing.assert_allclose(ratio.numpy(), 12 / 11, rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(9)
    (root / "images").mkdir()
    for g in range(3):
        low = (rng.random((4, 4, 3)) * 200 + 30).astype(np.uint8)
        base = np.asarray(Image.fromarray(low).resize((32, 32), Image.BILINEAR), np.float32)
        for i in range(3):
            img = np.clip(base + 6 * rng.standard_normal(base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / "images" / f"g{g}_{i}.png")
    weights = root / "densenet_tiny.pth"
    torch.save(as_torch(random_state_dict(DenseNetTiny(), 10)), weights)
    return root, weights


def test_densenet_index_crosses_both_ways(corpus):
    """A --dnn-model densenet-tiny flat index built by the port serves from
    the JAX engine, and the JAX package's from the port's: each corpus
    image finds itself first."""
    root, weights = corpus
    common = dict(data_dir=root / "images", method=Method.DNN,
                  dnn_model=DnnModel.DENSENET_TINY, index_type=IndexType.L2, resize_size=32,
                  embed_batch_size=4, torch_weights=weights, num_images_to_return=3)
    jax_art, port_art = root / "jax", root / "port"
    jax_indexer_main(Config(artifacts_dir=jax_art, **common))
    port_indexer.cli_main([
        "--data-dir", str(root / "images"), "--artifacts-dir", str(port_art), "--method", "dnn",
        "--dnn-model", "densenet-tiny", "--index-type", "l2", "--resize-size", "32",
        "--batch-size", "4", "--torch-weights", str(weights), "--device", "cpu"])
    got = np.load(port_art / "dnn_densenet-tiny_l2.index.npz")["vectors"]
    want = np.load(jax_art / "dnn_densenet-tiny_l2.index.npz")["vectors"]
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert got.shape == want.shape == (9, 32) and rel.max() <= 3e-2, rel  # bf16 embedders
    paths = load_paths_csv(port_art / "images.csv")
    assert paths == load_paths_csv(jax_art / "images.csv")

    jax_engine = JaxQueryEngine(Config(artifacts_dir=port_art, **common), prewarm=False)
    cfg, device = port_engine.parse_args([
        "--artifacts-dir", str(jax_art), "--dnn-model", "densenet-tiny", "--resize-size", "32",
        "--torch-weights", str(weights), "--device", "cpu", "--no-prewarm"])
    engine = port_engine.QueryEngine(cfg, device=device, prewarm=False)
    try:
        for path in paths:
            img = load_image(path)
            assert jax_engine.query(img, k=1)[0][2] == path
            assert engine.query(img, k=1)[0][2] == path
    finally:
        engine.close()
