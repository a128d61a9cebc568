"""The engine on a mesh on the CPU: artifacts built by the port's indexer
(flat l2, cell-probe, IVF-PQ with a rerank shortlist, BoVW), served by
``QueryEngine(cfg, mesh=Mesh([cpu] * 4))`` and by the unsharded engine on
the same artifacts: a third of the corpus images, as queries, get the same
ids, and distances within 1e-4 (the shard-local rerank clamps a distance
at 0 as the JAX package's does; the unsharded one may leave -1.5e-5).
The IVF families probe every cell (nprobe = nlist), so the per-shard
buckets hold the unsharded index's candidates; the IVF-PQ shortlist of 64
covers the 12 rows, so its ranking is exact. dHash ignores a mesh of one
process and is refused on a mesh over processes, as in the JAX engine.
"""

import numpy as np
import pytest
import torch

from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.config import (
    Config, CornerDescriptorKind, DnnModel, IndexType, Method)
from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.utils.imageio import load_image, save_paths_csv
from test_torch_port_slice import make_corpus

MESH = Mesh(["cpu"] * 4)


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
    return root / "images"


CASES = {
    "flat": dict(index_type=IndexType.L2),
    "cell-probe": dict(index_type=IndexType.CELL_PROBE, ivf_nlist=4, ivf_nprobe=4),
    "ivfpq": dict(index_type=IndexType.IVFPQ, ivf_nlist=4, ivf_nprobe=4, pq_m=16,
                  pq_rerank=64),
    "bovw": dict(method=Method.BOVW, corner_descriptor=CornerDescriptorKind.ORB, num_clusters=8,
                 max_descriptors_per_image=32, corner_n_levels=2, resize_size=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_engine_gives_the_unsharded_engines_answers(corpus, tmp_path, case):
    kw = dict(method=Method.DNN, dnn_model=DnnModel.RESNET_TINY, resize_size=32,
              embed_batch_size=4, num_images_to_return=5, precompute_thumbnails=False)
    kw.update(CASES[case])
    cfg = Config(data_dir=corpus, artifacts_dir=tmp_path / "art", **kw)
    port_indexer.main(cfg, device="cpu", mesh=MESH)  # a sharded build
    one = port_engine.QueryEngine(cfg, device="cpu", prewarm=False)
    sharded = port_engine.QueryEngine(cfg, device="cpu", mesh=MESH)
    try:
        index = sharded.index
        want = {"cell-probe": ShardedIVF, "ivfpq": ShardedIVFPQ}.get(case)
        if want is not None:
            assert type(index) is want
        else:
            assert index.mesh is MESH and len(index.store.vectors) == 4
        assert sharded._mh_coordinator is None and sharded._batched_search.coordinator is None
        for path in one.paths[::3]:
            img = load_image(path)
            d1, i1 = one._search(img, 5)
            d2, i2 = sharded._search(img, 5)
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-4)
        assert sharded.query(img)[0][2] == path  # its own image first
    finally:
        one.close()
        sharded.close()


def test_dhash_ignores_one_process_and_refuses_many(corpus, tmp_path):
    """dHash never shards: on a mesh of one process it serves as without
    one; it has no broadcast path, so on a mesh over processes the engine
    refuses it with the JAX engine's message (a worker would wait forever)
    before anything is loaded."""
    cfg = Config(data_dir=corpus, artifacts_dir=tmp_path / "art", method=Method.DHASH,
                 resize_size=32, precompute_thumbnails=False)
    port_indexer.main(cfg, device="cpu", mesh=MESH)
    one = port_engine.QueryEngine(cfg, device="cpu")
    meshed = port_engine.QueryEngine(cfg, device="cpu", mesh=MESH)
    try:
        img = load_image(one.paths[4])
        assert meshed.index is None and meshed._batched_search.coordinator is None
        np.testing.assert_array_equal(meshed._search(img, 5)[1], one._search(img, 5)[1])
    finally:
        one.close()
        meshed.close()
    save_paths_csv(["a.png"], tmp_path / "images.csv")
    cfg = Config(artifacts_dir=tmp_path, method=Method.DHASH)
    with pytest.raises(RuntimeError, match="multi-host serving supports fused index families "
                                           "only; method dhash has no broadcast-dispatch path"):
        port_engine.QueryEngine(cfg, device="cpu", mesh=Mesh(["cpu"], world=2))
