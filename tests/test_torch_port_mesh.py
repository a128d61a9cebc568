"""The port's mesh and scale-out flags (the counterparts of
``tests/test_cli_sharding.py``): ``parallel/mesh.py``'s meshes and
``mesh_from_config``, the ``--sharded`` / ``--dcn-*`` flags of both entry
points against the JAX package's parsers, a sharded build through the
indexer, and the ``scale_out`` twin on the 8-shard CPU mesh."""

import numpy as np
import pytest
import torch
from PIL import Image

from image_search_engine_tpu.engine import parse_args as jax_engine_args
from image_search_engine_tpu.indexer import parse_args as jax_indexer_args
from image_search_engine_tpu_torch import engine as port_engine
from image_search_engine_tpu_torch import indexer as port_indexer
from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method
from image_search_engine_tpu_torch.parallel import mesh as mesh_mod
from image_search_engine_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_config


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_mesh_from_config_none_by_default():
    assert mesh_from_config(Config(), "cpu") is None


def test_mesh_from_config_sharded_counts():
    """0 = all local devices (the CPU is one); N = N shards, which on the
    CPU repeat the one device, as the JAX tests' 8 virtual devices."""
    mesh = mesh_from_config(Config(shard_devices=0), "cpu")
    assert mesh is not None and mesh.size == 1 and mesh.axis == "data"
    mesh4 = mesh_from_config(Config(shard_devices=4), "cpu")
    assert mesh4.size == 4 and mesh4.devices == (torch.device("cpu"),) * 4
    assert (mesh4.rank, mesh4.world, mesh4.group, mesh4.first_shard) == (0, 1, None, 0)
    assert mesh4.one_device and mesh4.home == torch.device("cpu")


def test_mesh_from_config_dcn_needs_full_trio():
    with pytest.raises(ValueError, match="dcn-processes"):
        mesh_from_config(Config(dcn_coordinator="127.0.0.1:1234"), "cpu")


def test_mesh_from_config_dcn_partial_trio_rejected():
    # processes / process id without a coordinator fail loudly instead of
    # falling through to the environment's job
    with pytest.raises(ValueError, match="dcn-coordinator"):
        mesh_from_config(Config(dcn_num_processes=2, dcn_process_id=0), "cpu")


def test_mesh_from_config_dcn_auto_and_trio(monkeypatch):
    """'auto' joins the job the environment names (torchrun's env://), the
    trio joins tcp://HOST:PORT; with no --sharded, every device is used."""
    calls = []
    monkeypatch.setattr(mesh_mod, "init_multihost", lambda *a, **kw: calls.append((a, kw)) or 1)
    m = mesh_from_config(Config(dcn_coordinator="auto"), "cpu")
    assert calls == [((), {"device": "cpu"})] and m.size == 1
    m = mesh_from_config(Config(dcn_coordinator="h:1", dcn_num_processes=2, dcn_process_id=1,
                                shard_devices=3), "cpu")
    assert calls[1] == (("h:1", 2, 1), {"device": "cpu"}) and m.size == 3


def test_make_mesh_on_the_card_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)  # the card is the default
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])


@pytest.mark.parametrize("argv", [
    [], ["--sharded"], ["--sharded", "4"],
    ["--dcn-coordinator", "h:1", "--dcn-processes", "2", "--dcn-process-id", "1"],
    ["--dcn-coordinator", "auto", "--sharded", "2"]])
def test_engine_cli_flags_match_the_jax_engines(argv):
    base = ["--artifacts-dir", "/nonexistent", "--no-compile-cache"]
    cfg, device = port_engine.parse_args(base + argv)
    want = jax_engine_args(base + argv)
    assert device == "cuda"
    for field in ("shard_devices", "dcn_coordinator", "dcn_num_processes", "dcn_process_id"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_indexer_cli_flags_match_the_jax_indexers():
    argv = ["--data-dir", "/nonexistent", "--no-compile-cache", "--sharded", "8",
            "--dcn-coordinator", "h:2", "--dcn-processes", "4", "--dcn-process-id", "3"]
    cfg, device, _ = port_indexer.parse_args(argv)
    want, _ = jax_indexer_args(argv)
    assert device == "cuda"
    assert (cfg.shard_devices, cfg.dcn_coordinator, cfg.dcn_num_processes,
            cfg.dcn_process_id) == (want.shard_devices, want.dcn_coordinator,
                                    want.dcn_num_processes, want.dcn_process_id) == (
        8, "h:2", 4, 3)


def test_no_compile_cache_says_the_port_has_none(capsys):
    with pytest.raises(SystemExit):
        port_engine.parse_args(["--help"])
    assert "the port has no compile cache" in " ".join(capsys.readouterr().out.split())


def test_sharded_env_override(monkeypatch):
    monkeypatch.setenv("ISE_SHARDED", "4")
    assert Config.from_env().shard_devices == 4
    monkeypatch.delenv("ISE_SHARDED")
    assert Config.from_env().shard_devices is None


def test_indexer_main_builds_over_the_mesh(tmp_path):
    """--sharded 4 on the CPU: the embedder runs its replicas, the flat
    store is built sharded, and the artifact equals the unsharded build's."""
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(8):
        arr = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        Image.fromarray(arr).resize((32, 32)).save(img_dir / f"im{i}.png")
    common = dict(data_dir=img_dir, method=Method.DNN, dnn_model=DnnModel.RESNET_TINY,
                  index_type=IndexType.L2, resize_size=32, embed_batch_size=8,
                  precompute_thumbnails=False)
    sharded = Config(artifacts_dir=tmp_path / "sharded", shard_devices=4, **common)
    port_indexer.main(sharded, device="cpu")
    one = Config(artifacts_dir=tmp_path / "one", **common)
    port_indexer.main(one, device="cpu")
    with np.load(sharded.dnn_index_path) as a, np.load(one.dnn_index_path) as b:
        np.testing.assert_array_equal(a["vectors"], b["vectors"])
    engine = port_engine.QueryEngine(sharded, device="cpu", prewarm=False)
    try:  # QueryEngine alone loads unsharded; serve() builds the mesh
        assert len(engine.paths) == 8 and engine.mesh is None
    finally:
        engine.close()


def test_indexer_refuses_a_multi_process_build(tmp_path):
    cfg = Config(data_dir=tmp_path, artifacts_dir=tmp_path)
    with pytest.raises(SystemExit, match="does not support multi-host"):
        port_indexer.main(cfg, device="cpu", mesh=Mesh(["cpu"], world=2))


def test_scale_out_twin_on_the_cpu_mesh():
    from image_search_engine_tpu_torch.examples import scale_out

    out = scale_out.main(["--device", "cpu"])
    for step in ("flat", "ivf", "ivfpq", "ivfpq_rerank"):
        assert out[step] == [0, 1, 2, 3], step  # each query finds its own row
    assert out["pq_bytes_per_row"] == 8
