"""BoVW over the corner descriptors through the entry points on the CPU:
the port's indexer builds an ORB, SIFT or BRISK index (32 keypoints over a
2-level pyramid, k = 8, flat l2), and the JAX engine, reading the port's
pipeline ``.npz`` and index, answers every corpus image as the port's
engine does. Distances within 2e-4 (the engines round to 4 decimals), ids
equal but where two distances tie within it.
"""

import numpy as np
import pytest
import torch

from image_search_engine_tpu.config import Config as JaxConfig
from image_search_engine_tpu.config import Method as JaxMethod
from image_search_engine_tpu.engine import QueryEngine as JaxQueryEngine
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.bovw.pipeline import BoVWPipeline
from image_search_engine_tpu_torch.config import Config, Method
from image_search_engine_tpu_torch.utils.imageio import load_image
from test_torch_port_bovw import assert_same_ranking, make_corpus


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_corpus(root / "images", np.random.default_rng(0))
    return root


@pytest.mark.parametrize("kind", ["orb", "sift", "brisk"])
def test_corner_index_served_by_both_engines(corpus, tmp_path, kind):
    art = tmp_path / "art"
    port_indexer.cli_main(["--data-dir", str(corpus / "images"), "--artifacts-dir", str(art),
                           "--method", "bovw", "--corner-descriptor", kind, "--num-clusters", "8",
                           "--max-keypoints", "32", "--corner-n-levels", "2",
                           "--resize-size", "64", "--device", "cpu"])
    pipe = BoVWPipeline.load(art / "bovw_pipeline.npz", device="cpu")
    assert pipe.descriptor_kind == kind and pipe.descriptor_params["n_levels"] == 2
    assert pipe.descriptor_params["max_keypoints"] == 32
    # the engines take the descriptor from the artifact, not from their flags
    common = dict(artifacts_dir=art, resize_size=224, num_images_to_return=5)
    jax_engine = JaxQueryEngine(JaxConfig(method=JaxMethod.BOVW, **common))
    engine = port_engine.QueryEngine(Config(method=Method.BOVW, **common), device="cpu")
    try:
        assert engine._batched_search.programs == {}  # the CPU runs each dispatch eagerly
        for path in engine.paths:
            got = engine.query(load_image(path))
            assert_same_ranking(got, jax_engine.query(load_image(path)))
            assert got[0][0] == pytest.approx(0.0, abs=1e-4)  # its own histogram, or a twin
    finally:
        engine.close()
