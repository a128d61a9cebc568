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
    for new in ("models.densenet", "models.bit", "utils.checkpoint",
                "examples.siamese_workflow", *(f"training.siamese.{m}" for m in (
                    "config", "losses", "augmentations", "dataset", "model", "train",
                    "create_index", "eval", "serve")),
                "parallel.mesh", "parallel.topk", "parallel.kmeans", "parallel.ivf",
                "serving.multihost", "utils.cli", "examples.scale_out"):
        assert f"image_search_engine_tpu_torch.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke', 'probed_scan_sweep']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "    'optax', 'orbax', 'torchvision', 'transformers'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    """Not even the JAX package's jax-free host modules: the port keeps its
    own copies (config, image I/O, native loader, serving stats, the HTTP
    handler and its page, the micro-batcher, the descriptors, the BoVW
    pipeline, the corner ops, the siamese config and pair batches), and its
    own entry-point twins (graft_entry, the quickstart, the siamese
    workflow). Lazy imports are reached too: the upload page and the native
    loader's bindings."""
    mods = port_modules()
    for own in ("config", "utils.imageio", "utils.native_loader", "utils.profiling",
                "serving.http", "serving.batching", "frontend", "graft_entry",
                "examples.quickstart", "descriptors", "bovw.pipeline", "ops.corners",
                "training.siamese.config", "training.siamese.dataset",
                "examples.siamese_workflow", "utils.cli", "serving.multihost",
                "examples.scale_out"):
        assert f"image_search_engine_tpu_torch.{own}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke', 'probed_scan_sweep']!r}:\n"
            "    importlib.import_module(m)\n"
            "from image_search_engine_tpu_torch.serving.http import _UI_FALLBACK_HTML, _ui_html\n"
            "page = _ui_html()\n"
            "assert 'similar_images' in page and page != _UI_FALLBACK_HTML\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'image_search_engine_tpu')\n"
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


def test_siamese_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without CUDA every siamese entry point refuses its default device
    instead of moving to the CPU."""
    from image_search_engine_tpu_torch.training.siamese import create_index, eval, serve, train
    from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SiameseConfig(backbone="densenet-tiny", image_size=(32, 32), ckpt_dir=tmp_path)
    calls = (lambda: train.Trainer(cfg),
             lambda: create_index.create_index(cfg, tmp_path, tmp_path / "i.npz", tmp_path / "c"),
             lambda: serve.SiameseQueryEngine(cfg, tmp_path / "i.npz", tmp_path / "c"),
             lambda: eval.card_retrieval_metrics(lambda x: x.reshape(len(x), -1),
                                                 *eval.make_synthetic_card_corpus(2, 8, 1)),
             lambda: train.main(["--train-dir", str(tmp_path), "--valid-dir", str(tmp_path),
                                 "--backbone", "densenet-tiny"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_build_names_missing_nvcc(monkeypatch, tmp_path):
    from image_search_engine_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


def test_kernel_build_compiles_each_source_then_links_one_library(monkeypatch, tmp_path):
    """The build orchestration, with a stand-in compiler that writes its
    ``-o`` file and echoes its arguments: one compile per source, one link,
    the log kept beside the library, nothing else left in the build
    directory, and a changed header names a new library."""
    from image_search_engine_tpu_torch.ops import _kernels

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nout=""; prev=""\nfor a in "$@"; do\n'
                    '  [ "$prev" = "-o" ] && out="$a"; prev="$a"\ndone\n'
                    'echo "compiled $*"\necho obj > "$out"\n')
    fake.chmod(0o755)
    header = tmp_path / "scoring.cuh"
    header.write_text("// v1\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "HEADERS", (header,))
    path, _ = _kernels.build()
    log = path.with_suffix(".log").read_text()
    for src in _kernels.SOURCES:
        assert f"== {src.name}" in log and f"-c {src}" in log
    assert log.count(" -c ") == len(_kernels.SOURCES) and log.count("-shared") == 1
    assert path.read_text() == "obj\n"  # the library is the link's output
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    assert _kernels.build() == (path, 0.0)  # built once per hash
    header.write_text("// v2\n")
    assert _kernels.library_path() != path


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_probed_scan_sweep_refuses_to_run_without_cuda():
    out = subprocess.run([sys.executable, "probed_scan_sweep.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr
