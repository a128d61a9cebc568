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


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` means the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)
