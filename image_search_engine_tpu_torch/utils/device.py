"""Explicit device selection: no silent move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. ``"cpu"`` runs every kernel's plain PyTorch version."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch versions)")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: want 'cuda' or 'cpu'")
