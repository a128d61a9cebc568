"""The twin of ``__graft_entry__.dryrun_multichip`` on the CPU:
``graft_entry.dryrun_multichip(n, device="cpu")`` over a mesh of n shards of
the CPU runs the JAX function's steps at its shapes (its data-parallel
step's loss held to the unsharded step's), then a siamese index built on
the mesh and served, and a dHash engine made with the mesh."""

import pytest
import torch

from image_search_engine_tpu_torch.graft_entry import dryrun_multichip


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n_devices", [4, 1])
def test_dryrun_multichip_on_the_cpu(n_devices, capsys):
    out = dryrun_multichip(n_devices, device="cpu")
    line = capsys.readouterr().out
    assert f"dryrun_multichip({n_devices}, cpu): train loss" in line
    assert "siamese create_index + serve and dHash engine queries ok" in line
    assert out["certified"] == 4 and out["bovw_certified"] == 2
    assert out["launches"] == {}  # the plain versions on the CPU: no kernel
