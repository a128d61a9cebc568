"""Okapi BM25 weighting for codeword histograms.

Port of ``image_search_engine_tpu/ops/bm25.py``, which keeps the
reference's ``OkapiTransformer`` semantics:

  * ``fit`` learns idf = log((N - df + 0.5) / (df + 0.5)), df the number
    of documents holding each codeword;
  * ``transform`` applies only the saturation k1 x / (k1 x + k2 (1 - b + b
    dl / avgdl)); the idf is multiplied in only with ``apply_idf=True``;
  * avgdl is the transform batch's own unless ``use_train_avgdl``, which
    reuses the corpus statistic (the BoVW pipeline's default: a one-image
    query batch would otherwise see dl / avgdl = 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def idf_fit(hist: torch.Tensor) -> torch.Tensor:
    """Per-codeword idf of a (N, K) count matrix."""
    n = hist.shape[0]
    df = torch.sum(hist > 0, dim=0).to(torch.float32)
    return torch.log((n - df + 0.5) / (df + 0.5))


def bm25_transform(hist: torch.Tensor, k1: float = 1.0, k2: float = 1.0, b: float = 0.75,
                   avgdl: Optional[float] = None) -> torch.Tensor:
    """BM25 saturation over a (B, K) count matrix. ``avgdl`` is a Python
    number (the corpus statistic, as the f32 the JAX package passes) or
    None for the batch's own mean document length; a number keeps the
    function free of host-to-device copies, so a captured dispatch can run
    it."""
    x = hist.to(torch.float32)
    dl = torch.sum(x, dim=1, keepdim=True)
    if avgdl is None:
        denom = torch.clamp(torch.mean(dl), min=1e-12)
    else:
        denom = max(float(np.float32(avgdl)), 1e-12)
    denom_add = k2 * (1.0 - b + b * dl / denom)
    num = k1 * x
    out = num / (num + denom_add)
    # zero counts stay exactly zero (an all-empty histogram's 0 / 0 too)
    return torch.where(x > 0, out, 0.0)


@dataclasses.dataclass
class OkapiBM25:
    """Fit/transform facade with the reference transformer's surface;
    numpy out, computed on the device of the histograms it is given."""

    k1: float = 1.0
    k2: float = 1.0
    b: float = 0.75
    use_idf: bool = True
    apply_idf: bool = False  # the reference never multiplies idf in transform
    use_train_avgdl: bool = False

    idf_: Optional[np.ndarray] = None
    avgdl_: Optional[float] = None

    def fit(self, hist) -> "OkapiBM25":
        h = torch.as_tensor(hist).to(torch.float32)
        if self.use_idf:
            self.idf_ = idf_fit(h).cpu().numpy()
        self.avgdl_ = float(torch.mean(torch.sum(h, dim=1)))
        return self

    def transform(self, hist) -> np.ndarray:
        h = torch.as_tensor(hist).to(torch.float32)
        avgdl = self.avgdl_ if (self.use_train_avgdl and self.avgdl_) else None
        out = bm25_transform(h, self.k1, self.k2, self.b, avgdl=avgdl)
        if self.apply_idf:
            if self.idf_ is None:
                raise ValueError("fit first (use_idf=True)")
            out = out * torch.as_tensor(self.idf_, device=out.device)[None, :]
        return out.cpu().numpy()

    def fit_transform(self, hist) -> np.ndarray:
        return self.fit(hist).transform(hist)
