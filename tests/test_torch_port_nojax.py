"""The port imports no jax, refuses a missing CUDA device, and names the
missing toolkit when it cannot build its kernels."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "image_search_engine_tpu_torch"


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_and_chip_smoke_import_no_jax():
    mods = port_modules()
    assert "image_search_engine_tpu_torch.ops.topk" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cuda_device_raises_without_cuda(monkeypatch):
    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlatIndex("l2", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNEmbedder("resnet-tiny", device="cuda")


def test_kernel_build_names_missing_nvcc(monkeypatch, tmp_path):
    from image_search_engine_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0 and out.stdout == ""
