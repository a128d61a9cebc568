"""A whole run of each cell on the CPU (the harness's look for a chip
skipped, the cells' shapes cut small), sound and with the timed path
broken underneath: ``correct`` must come out true, then false for each
fault the cell can have: an answer altered where it is produced, and half
of a batch left out (its answers taken from the other half)."""

import numpy as np
import pytest
import torch

from portbench.run import run_cell
from portbench.tests.small import CELLS, SECONDS

SEED = 2 ** 31 + 99


def _run(cell, **mix):
    over = {"config": CELLS[cell]["config"], "mix": {**CELLS[cell]["mix"], **mix}}
    return run_cell(cell, SEED, SECONDS, False, "cpu", overrides=over)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    run = _run(cell)
    assert run["result"]["correct"], run["checks"]
    assert run["result"]["failed"] == 0


def _altered(i: np.ndarray, n: int) -> np.ndarray:
    i = i.copy()
    i[0, 0] = (i[0, 0] + n // 2) % n
    return i


def _half(a: np.ndarray) -> np.ndarray:
    a = a.copy()
    h = a.shape[0] // 2
    a[h:] = a[:a.shape[0] - h]
    return a


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_batch_search_is_not_correct(monkeypatch, fault):
    from image_search_engine_tpu_torch.index.flat import FlatIndex

    search = FlatIndex.search

    def broken(self, q, k):
        d, i = search(self, q, k)
        return (d, _altered(i, self.ntotal)) if fault == "altered" else (_half(d), _half(i))

    monkeypatch.setattr(FlatIndex, "search", broken)
    run = _run("exact-1m-d128-bf16.q4096")
    assert not run["result"]["correct"], run["checks"]


@pytest.mark.parametrize("cell", ["resnet50-flat-1m.open-mb8"])
def test_a_served_answer_altered_is_not_correct(monkeypatch, cell):
    from image_search_engine_tpu_torch.serving import fused

    tail = fused.faiss_tail

    def broken(d, i, k, descending):
        d, i = tail(d, i, k, descending)
        return d, _altered(i, CELLS[cell]["config"]["rows"])

    monkeypatch.setattr(fused, "faiss_tail", broken)
    run = _run(cell)
    assert not run["result"]["correct"], run["checks"]


def test_a_micro_batch_with_half_its_riders_answered_wrong_is_not_correct(monkeypatch):
    """The second half of a batch's riders get the first half's answers; every
    request judged, so any batch of two riders or more shows it."""
    from image_search_engine_tpu_torch.serving import fused

    call = fused.BatchedSearch.__call__

    def broken(self, images, k):
        d, i = call(self, images, k)
        n = int((images.reshape(len(images), -1).max(1) > 0).sum())  # riders: padding is zeros
        return (np.concatenate([_half(d[:n]), d[n:]]), np.concatenate([_half(i[:n]), i[n:]]))

    monkeypatch.setattr(fused.BatchedSearch, "__call__", broken)
    run = _run("resnet50-flat-1m.open-mb8", sample_requests=10_000)
    assert not run["result"]["correct"], run["checks"]


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_embedding_is_not_correct(monkeypatch, fault):
    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    embed = CNNEmbedder.embed_batch

    def broken(self, images):
        e = embed(self, images)
        if fault == "half":
            return _half(e)
        e = e.copy()
        e[0] *= 1.1
        return e

    monkeypatch.setattr(CNNEmbedder, "embed_batch", broken)
    run = _run("resnet50-flat-1m.index-b64", sample_rows=10 ** 6)  # every row judged
    assert not run["result"]["correct"], run["checks"]


@pytest.mark.parametrize("fault", ["replaced", "rounded"])
def test_a_broken_growth_of_the_store_is_not_correct(monkeypatch, fault):
    """The window's add replaces the store instead of growing it, or
    rebuilds the old rows rounded to bf16."""
    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.index.store import VectorStore

    add = FlatIndex.add

    def broken(self, x):
        if self.store is not None:
            if fault == "replaced":
                self.store = None
            else:
                old = self.store.values().to(torch.bfloat16).float()
                self.store = VectorStore.build(old, dtype=self.dtype, device=self.device)
        return add(self, x)

    monkeypatch.setattr(FlatIndex, "add", broken)
    run = _run("resnet50-flat-1m.index-b64")
    assert not run["result"]["correct"], run["checks"]
