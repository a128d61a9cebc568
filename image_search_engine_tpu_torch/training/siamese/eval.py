"""Index evaluation harness.

Port of ``image_search_engine_tpu/training/siamese/eval.py``:
``query_index`` runs the same query through the flat index and through
an explicit brute-force NumPy scan (the reference's correctness oracle);
``card_retrieval_metrics`` measures what training buys on a synthetic
single-instance-per-class card corpus (``make_synthetic_card_corpus``:
the JAX package's cards from the same numpy seed, its queries from the
port's augmentation); ``display_query_results`` renders a matplotlib grid
(imported only when called).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.flat import FlatIndex


def query_index(
    query_emb: np.ndarray,
    index: FlatIndex | np.ndarray,
    backend: str = "flat",
    k: int = 9,
) -> Tuple[np.ndarray, np.ndarray]:
    """Search with either the real index or the brute-force oracle.

    backend="flat": FlatIndex IP search. backend="bruteforce": per-row L2
    over a raw embedding matrix + a stable argsort.
    """
    q = np.atleast_2d(np.asarray(query_emb, np.float32))
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    if backend == "flat":
        assert isinstance(index, FlatIndex)
        return index.search(q, k)
    if backend == "bruteforce":
        mat = np.asarray(index, np.float32)
        d = np.linalg.norm(mat[None, :, :] - q[:, None, :], axis=2)
        idx = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(d, idx, axis=1), idx
    raise ValueError(f"unknown backend {backend!r}")


def recall_at_k(got: np.ndarray, want: np.ndarray) -> float:
    hits = sum(len(set(g.tolist()) & set(w.tolist())) for g, w in zip(got, want))
    return hits / want.size


def synthetic_cards(n_cards: int, size: int, seed: int = 0) -> np.ndarray:
    """(n_cards, size, size, 3) f32 [0, 1] canonical cards: sharp random
    8 x 8 block patterns, upsampled nearest (the JAX package's, from the
    same numpy draws)."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n_cards, 8, 8, 3)) > 0.5).astype(np.float32)
    base = base * (0.3 + 0.7 * rng.random((n_cards, 8, 8, 3)).astype(np.float32))
    rows = np.minimum(((np.arange(size) + 0.5) * 8 / size).astype(np.int64), 7)
    return np.ascontiguousarray(base[:, rows][:, :, rows])


def make_synthetic_card_corpus(
    n_cards: int, size: int, q_per: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-instance-per-class retrieval corpus, the reference's card
    setting: every class has ONE canonical image (a sharp random 8 x 8
    block pattern, upsampled nearest to ``size``); queries are the TRAINING
    augmentation applied with held-out seeds (777,000 + card), so retrieval
    quality measures exactly the invariance the siamese loss trains. The
    augmentation runs on the CPU.

    Returns (cards (C, S, S, 3) f32 [0,1], queries (C*q_per, S, S, 3),
    qlabel (C*q_per,) true-card ids).
    """
    from image_search_engine_tpu_torch.training.siamese.augmentations import augment_batch

    cards = synthetic_cards(n_cards, size, seed)
    queries = np.empty((n_cards * q_per, size, size, 3), np.float32)
    qlabel = np.repeat(np.arange(n_cards, dtype=np.int32), q_per)
    for c in range(n_cards):
        batch = torch.from_numpy(np.repeat(cards[c][None], q_per, 0))
        gen = torch.Generator().manual_seed(777_000 + c)
        queries[c * q_per:(c + 1) * q_per] = augment_batch(gen, batch).numpy()
    return cards, queries, qlabel


def card_retrieval_metrics(embed_fn, cards, queries, qlabel, k: int = 3,
                           device="cuda") -> dict:
    """Retrieval quality of an embedding function on the card corpus:
    index the cards (flat IP over L2-normalized embeddings on ``device``,
    the create_index + query_index flow), query the photos.

    Returns {"recall_at_1", "top{k}_hit", "gap"} — gap is the mean
    true-card-vs-others cosine margin (it grows when training learns
    augmentation invariance, and collapses to ~0 when the embedder
    degenerates).
    """
    def norm(e):
        return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)

    ce, qe = norm(embed_fn(cards)), norm(embed_fn(queries))
    idx = FlatIndex("ip", device=device).add(ce)
    _, top = idx.search(qe, k)
    r1 = float((top[:, 0] == qlabel).mean())
    hit = float(np.mean([qlabel[i] in set(top[i].tolist()) for i in range(len(qlabel))]))
    sim = qe @ ce.T
    pos = sim[np.arange(len(qlabel)), qlabel]
    neg = (sim.sum(1) - pos) / (ce.shape[0] - 1)
    return {"recall_at_1": r1, f"top{k}_hit": hit, "gap": float((pos - neg).mean())}


def display_query_results(
    query_image: np.ndarray,
    result_images: Sequence[np.ndarray],
    distances: Sequence[float],
    out_path: str | Path | None = None,
):
    """Matplotlib grid of the query and its top-k results with distances.
    matplotlib is imported here, and only here (an optional dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(result_images) + 1
    cols = min(n, 5)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(query_image)
    axes[0].set_title("query")
    for i, (img, d) in enumerate(zip(result_images, distances), start=1):
        axes[i].imshow(img)
        axes[i].set_title(f"{d:.3f}")
    for ax in axes:
        ax.axis("off")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
