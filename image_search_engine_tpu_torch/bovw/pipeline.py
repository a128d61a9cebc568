"""BoVW modelling pipeline: codebook + histograms + BM25.

Port of ``image_search_engine_tpu/bovw/pipeline.py`` (the reference's
sklearn ``Pipeline([("bovw", BOVW), ("tfidf", OkapiTransformer)])``):

  * ``fit``: a spherical k-means codebook over every valid descriptor
    (ops/kmeans.py: its assignment is the port's k-means kernel on the
    card), every descriptor quantized, codeword histograms scattered
    (ops/histogram.py), BM25 statistics fitted (ops/bm25.py);
  * ``transform``: quantize -> histogram -> BM25 for a batch; the serving
    dispatch runs the same chain on the device (serving/fused.
    bovw_prologue);
  * an optional codebook-size sweep scored by a sampled Davies-Bouldin
    index;
  * the artifact is one ``.npz`` with the JAX package's keys, so a pipeline
    saved by either package loads in the other.

The codebook's random restarts draw from ``torch.Generator``, not
``jax.random``, so a pipeline fitted here has other centroids than one the
JAX package fits on the same descriptors; a loaded pipeline transforms as
the package that saved it does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.ops.bm25 import OkapiBM25
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.histogram import batched_histograms
from image_search_engine_tpu_torch.ops.kmeans import KMeans, assign

log = logging.getLogger(__name__)


def flatten_valid_descriptors(features: np.ndarray, valid: Optional[np.ndarray]) -> np.ndarray:
    """(B, K, D) + (B, K) mask -> (T, D) rows of real descriptors."""
    if valid is None:
        return features.reshape(-1, features.shape[-1])
    return features[valid]


def davies_bouldin_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Davies-Bouldin index in plain NumPy (lower = tighter clusters), as
    ``sklearn.metrics.davies_bouldin_score``: S_i the mean distance to
    centroid i; the mean over i of max_{j != i} (S_i + S_j) / d(c_i, c_j)."""
    uniq = np.unique(labels)
    k = uniq.shape[0]
    if k < 2:
        raise ValueError("davies_bouldin_score needs >= 2 clusters")
    cents = np.empty((k, x.shape[1]), np.float64)
    disp = np.empty(k, np.float64)
    for i, u in enumerate(uniq):
        pts = x[labels == u].astype(np.float64)
        cents[i] = pts.mean(axis=0)
        disp[i] = np.sqrt(((pts - cents[i]) ** 2).sum(axis=1)).mean()
    diff = cents[:, None, :] - cents[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    ratio = (disp[:, None] + disp[None, :]) / np.where(dist > 0, dist, np.inf)
    np.fill_diagonal(ratio, 0.0)
    return float(ratio.max(axis=1).mean())


def sampled_cluster_score(descriptors: np.ndarray, labels: np.ndarray, sample_size: int = 2000,
                          repeats: int = 10, seed: int = 0) -> float:
    """Mean Davies-Bouldin over random subsamples, negated so that higher
    is better."""
    rng = np.random.default_rng(seed)
    scores = []
    n = descriptors.shape[0]
    for _ in range(repeats):
        idx = rng.choice(n, size=min(sample_size, n), replace=False)
        if len(np.unique(labels[idx])) < 2:
            continue
        scores.append(-davies_bouldin_score(descriptors[idx], labels[idx]))
    return float(np.mean(scores)) if scores else -np.inf


@dataclasses.dataclass
class BoVWPipeline:
    """fit/transform: descriptor sets -> BM25-weighted codeword histograms,
    on ``device`` (CUDA unless the caller asks for the CPU)."""

    n_clusters: int = 200
    kmeans_niter: int = 25
    kmeans_nredo: int = 3
    kmeans_seed: int = 42
    spherical: bool = True
    bm25_k1: float = 1.0
    bm25_k2: float = 1.0
    bm25_b: float = 0.75
    use_train_avgdl: bool = True
    # what built the descriptors, so the engine rebuilds the same
    # descriptor from the artifact alone
    descriptor_kind: str = ""
    descriptor_params: Optional[dict] = None
    device: str | torch.device = "cuda"

    kmeans: Optional[KMeans] = None
    bm25: Optional[OkapiBM25] = None

    def fit(self, features: np.ndarray, valid: Optional[np.ndarray]) -> "BoVWPipeline":
        rows = flatten_valid_descriptors(features, valid)
        log.info("training codebook: %d descriptors -> k=%d", rows.shape[0], self.n_clusters)
        self.kmeans = KMeans(n_clusters=self.n_clusters, niter=self.kmeans_niter,
                             nredo=self.kmeans_nredo, seed=self.kmeans_seed,
                             spherical=self.spherical, device=self.device).fit(rows)
        self.bm25 = OkapiBM25(k1=self.bm25_k1, k2=self.bm25_k2, b=self.bm25_b,
                              use_train_avgdl=self.use_train_avgdl).fit(
            self._histograms(features, valid))
        return self

    def fit_transform(self, features, valid) -> np.ndarray:
        return self.fit(features, valid).transform(features, valid)

    @torch.inference_mode()
    def _histograms(self, features: np.ndarray, valid: Optional[np.ndarray]) -> torch.Tensor:
        """(B, K, D) descriptor sets -> (B, n_clusters) counts on the device."""
        if self.kmeans is None:
            raise ValueError("fit first")
        b, k, d = features.shape
        dev = self.kmeans.device
        rows = torch.as_tensor(features, device=dev).reshape(-1, d).to(torch.float32)
        if self.spherical:
            rows = l2_normalize(rows)
        codes, _ = assign(rows, torch.as_tensor(self.kmeans.cluster_centers_, device=dev))
        valid = (torch.ones((b, k), dtype=torch.bool, device=dev) if valid is None
                 else torch.as_tensor(valid, device=dev))
        return batched_histograms(codes.reshape(b, k), valid, self.n_clusters)

    def transform(self, features: np.ndarray, valid: Optional[np.ndarray]) -> np.ndarray:
        """(B, K, D) descriptor sets -> (B, n_clusters) weighted histograms."""
        if self.bm25 is None:
            raise ValueError("fit first")
        return self.bm25.transform(self._histograms(features, valid))

    def save(self, path: str | Path) -> None:
        if self.kmeans is None or self.bm25 is None:
            raise ValueError("fit first")
        np.savez_compressed(
            path,
            centroids=self.kmeans.cluster_centers_,
            inertia=np.float64(self.kmeans.inertia_ or 0.0),
            idf=self.bm25.idf_ if self.bm25.idf_ is not None else np.zeros(0),
            avgdl=np.float64(self.bm25.avgdl_ or 0.0),
            params=np.asarray([self.n_clusters, self.kmeans_niter, self.kmeans_nredo,
                               self.kmeans_seed, int(self.spherical),
                               int(self.use_train_avgdl)], np.float64),
            bm25_params=np.asarray([self.bm25_k1, self.bm25_k2, self.bm25_b], np.float64),
            descriptor_kind=np.array(self.descriptor_kind),
            descriptor_params=np.array(json.dumps(self.descriptor_params or {})),
        )

    @classmethod
    def load(cls, path: str | Path, device="cuda") -> "BoVWPipeline":
        z = np.load(path, allow_pickle=False)
        p, bp = z["params"], z["bm25_params"]
        self = cls(n_clusters=int(p[0]), kmeans_niter=int(p[1]), kmeans_nredo=int(p[2]),
                   kmeans_seed=int(p[3]), spherical=bool(p[4]), use_train_avgdl=bool(p[5]),
                   bm25_k1=float(bp[0]), bm25_k2=float(bp[1]), bm25_b=float(bp[2]),
                   device=device)
        self.kmeans = KMeans(n_clusters=int(p[0]), spherical=bool(p[4]), device=device)
        self.kmeans.cluster_centers_ = z["centroids"]
        self.kmeans.inertia_ = float(z["inertia"])
        self.bm25 = OkapiBM25(k1=float(bp[0]), k2=float(bp[1]), b=float(bp[2]),
                              use_train_avgdl=bool(p[5]))
        self.bm25.idf_ = z["idf"] if z["idf"].size else None
        self.bm25.avgdl_ = float(z["avgdl"])
        if "descriptor_kind" in z.files:
            self.descriptor_kind = str(z["descriptor_kind"])
            self.descriptor_params = json.loads(str(z["descriptor_params"]))
        return self


def sweep_num_clusters(features: np.ndarray, valid: Optional[np.ndarray],
                       candidates: Sequence[int], sample_size: int = 2000, repeats: int = 10,
                       device="cuda") -> Tuple[int, dict]:
    """Codebook-size sweep scored by the sampled Davies-Bouldin index:
    (best k, {k: score})."""
    rows = flatten_valid_descriptors(features, valid)
    scores = {}
    for k in candidates:
        km = KMeans(n_clusters=int(k), niter=15, nredo=1, spherical=True,
                    device=device).fit(rows)
        labels = km.transform(rows)[:, 0]
        scores[int(k)] = sampled_cluster_score(rows, labels, sample_size, repeats)
        log.info("n_clusters=%d -> sampled DB score %.4f", k, scores[int(k)])
    best = max(scores, key=scores.get)
    return best, scores
