"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, for tests that need a CUDA device, and the fixture
that decides, inside the test, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def cuda_device():
    """``cuda:0``, or a skip where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on an NVIDIA GPU")
    return "cuda:0"
