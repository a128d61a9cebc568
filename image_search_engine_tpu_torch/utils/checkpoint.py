"""Checkpointing for arbitrary trees of tensors (model state, index arrays).

Port of ``image_search_engine_tpu/utils/checkpoint.py`` on ``torch.save``.
A tree is nested dicts, lists and tuples of tensors and Python scalars.
``save_tree_file`` / ``load_tree_file`` write and read one tree as one
file; the siamese ``Trainer``'s epoch checkpoints are such files.
``save_pytree`` / ``load_pytree`` write and read a tree as a checkpoint
directory holding ``tree.pt``, and ``CheckpointManager`` keeps
step-numbered directories (``<dir>/<step>/tree.pt``) with retention. The
JAX package stores these with orbax, which is not on the card's machine;
reading its orbax directories is out of scope (the port's own files only).
"""

from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

_FILE = "tree.pt"


def _like(tree: Any, target: Any) -> Any:
    """``tree`` with each tensor on the device and of the dtype of its
    counterpart in ``target``; the structures must match."""
    if torch.is_tensor(target):
        if not torch.is_tensor(tree) or tree.shape != target.shape:
            raise ValueError(f"checkpoint leaf {getattr(tree, 'shape', type(tree))} does not "
                             f"match the target's {tuple(target.shape)}")
        return tree.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            raise ValueError("checkpoint keys differ from the target's")
        return {k: _like(tree[k], target[k]) for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError("checkpoint sequence differs from the target's")
        return type(target)(_like(a, b) for a, b in zip(tree, target))
    return tree


def save_tree_file(path: str | Path, tree: Any) -> None:
    """Write ``tree`` to the file ``path``, whole or not at all (a partial
    write never takes the name)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".partial")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_tree_file(path: str | Path, target: Optional[Any] = None) -> Any:
    """Read a tree written by ``save_tree_file`` on the CPU; with ``target``
    (a matching tree of tensors), each tensor lands on its counterpart's
    device and dtype."""
    tree = torch.load(str(path), map_location="cpu", weights_only=True)
    return tree if target is None else _like(tree, target)


def save_pytree(path: str | Path, tree: Any, *, force: bool = True) -> None:
    """Save ``tree`` as the checkpoint directory ``path`` (replaced when it
    exists and ``force``; else an existing directory raises)."""
    path = Path(path).resolve()
    if path.exists():
        if not force:
            raise FileExistsError(f"checkpoint {path} exists (pass force=True)")
        shutil.rmtree(path)
    path.mkdir(parents=True)
    save_tree_file(path / _FILE, tree)


def load_pytree(path: str | Path, target: Optional[Any] = None) -> Any:
    """Restore a tree saved by ``save_pytree`` (``load_tree_file``'s
    ``target``)."""
    return load_tree_file(Path(path).resolve() / _FILE, target)


class CheckpointManager:
    """Step-numbered checkpoint directories with retention: after each
    ``save`` only the ``max_to_keep`` newest steps remain."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _FILE).exists())

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self.directory / str(step), tree)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, step: Optional[int] = None, target: Optional[Any] = None) -> Any:
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_pytree(self.directory / str(step), target)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass
