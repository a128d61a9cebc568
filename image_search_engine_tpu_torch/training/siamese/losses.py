"""Metric-learning losses: triplet and circle.

Port of ``image_search_engine_tpu/training/siamese/losses.py``, same math:

  * triplet: squared-L2 margin loss
        max(||a-p||^2 - ||a-n||^2 + margin, 0),  margin=0.5
  * circle (Sun et al. 2020), cosine-similarity form with m=0.25,
    scale(gamma)=256, in the numerically stable shape
        softplus(logsumexp(logit_n) + logsumexp(logit_p))
    with alpha_p = relu(Op - sg(sp)), alpha_n = relu(sg(sn) - On),
    Op = 1+m, On = -m, margin_p = 1-m, margin_n = m; one logsumexp over
    the whole batch, so the loss is a scalar;
  * the pair-based self-supervised circle loss: each (anchor_i,
    positive_i) pair is the positive, every cross pair a negative (the
    diagonal masked with -inf among the negatives).

``sg`` (``jax.lax.stop_gradient``) is ``.detach()``; softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it (no linear cut-off).
"""

from __future__ import annotations

import torch

from image_search_engine_tpu_torch.ops.distances import l2_normalize


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def triplet_loss(anchor, positive, negative, margin: float = 0.5) -> torch.Tensor:
    """Per-example squared-L2 triplet loss."""
    ap = torch.sum((anchor - positive) ** 2, dim=-1)
    an = torch.sum((anchor - negative) ** 2, dim=-1)
    return torch.clamp(ap - an + margin, min=0.0)


def _cosine(a, b):
    return torch.sum(l2_normalize(a) * l2_normalize(b), dim=-1)


def circle_loss(anchor, positive, negative, margin: float = 0.25,
                scale: float = 256.0) -> torch.Tensor:
    """Triplet-form circle loss, a scalar over the batch."""
    sp = _cosine(anchor, positive)
    sn = _cosine(anchor, negative)
    op, on = 1.0 + margin, -margin
    alpha_p = torch.relu(op - sp.detach())
    alpha_n = torch.relu(sn.detach() - on)
    logit_p = -scale * alpha_p * (sp - (1.0 - margin))
    logit_n = scale * alpha_n * (sn - margin)
    return _softplus(torch.logsumexp(logit_n, dim=0) + torch.logsumexp(logit_p, dim=0))


def self_supervised_circle_loss(anchor, positive, margin: float = 0.25,
                                scale: float = 256.0) -> torch.Tensor:
    """Pair-based circle loss: (B, D) anchors vs (B, D) positives; the
    matched row is the positive, all other rows are negatives."""
    a = l2_normalize(anchor)
    p = l2_normalize(positive)
    sim = a @ p.T  # (B, B): diag = positives, off-diag = negatives
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    op, on = 1.0 + margin, -margin
    sp = torch.diagonal(sim)
    alpha_p = torch.relu(op - sp.detach())
    logit_p = -scale * alpha_p * (sp - (1.0 - margin))  # (B,)
    alpha_n = torch.relu(sim.detach() - on)
    logit_n = scale * alpha_n * (sim - margin)  # (B, B)
    logit_n = logit_n.masked_fill(eye, float("-inf"))  # drop the diagonal
    lse_n = torch.logsumexp(logit_n, dim=1)  # (B,)
    return torch.mean(_softplus(logit_p + lse_n))


LOSSES = {
    "triplet": lambda a, p, n: torch.mean(triplet_loss(a, p, n)),
    "circle": circle_loss,
    "self_supervised_circle": lambda a, p, n=None: self_supervised_circle_loss(a, p),
}
