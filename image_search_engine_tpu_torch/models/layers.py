"""Layers shared by the port's backbones and the siamese head.

``BatchNorm1d`` / ``BatchNorm2d`` keep Flax's running statistics: in
training they normalize with the batch's biased variance, as torch does,
and update ``running_var`` with that same biased variance (Flax's
``batch_stats``), where torch's own BatchNorm folds in the unbiased one (a
factor n / (n - 1): 12 / 11 at the siamese head's 3 x 4 rows). The update
reads the statistics that the normalization itself computed
(``torch.native_batch_norm``'s mean and inverse standard deviation, the
variance being ``invstd ** -2 - eps``), so the batch is reduced once. The
momentum is torch's convention, 0.1 (Flax's 0.9), and the update is
``0.9 * running + 0.1 * batch`` in Flax's order of operations. In eval
mode they are torch's layers.

In a data-parallel train step (``parallel/data_parallel.py``) each shard
of the global batch runs the net on its own thread under
:func:`shard_batch_norm`. A BatchNorm in training mode then hands its
input to that context, which normalizes it with the statistics of the
global batch and updates the running statistics once for the step.

``flax_init_`` is the Flax modules' random init (``lecun_normal``
kernels: a truncated normal at +-2 std, variance 1 / fan_in after
truncation), which the port's random backbones and head mirror.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn

from image_search_engine_tpu_torch.models.resnet import _TRUNC_STD


_SHARD = threading.local()  # this thread's data-parallel shard, if any


@contextlib.contextmanager
def shard_batch_norm(sync):
    """Route this thread's training-mode BatchNorms to ``sync.batch_norm(bn,
    x)`` for the enclosed forward (one shard of a data-parallel step)."""
    prev = getattr(_SHARD, "sync", None)
    _SHARD.sync = sync
    try:
        yield
    finally:
        _SHARD.sync = prev


class _FlaxRunningStats:
    """Training-mode forward with Flax's running-statistics update."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        sync = getattr(_SHARD, "sync", None)
        if sync is not None:
            return sync.batch_norm(self, x)
        out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                    0.0, self.eps)
        with torch.no_grad():
            var = invstd.float().pow(-2) - self.eps
            mean = mean.float()
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is when it is f64 (a float64 run of the net
    stays float64: the chip check's reference step)."""
    return x if x.dtype == torch.float64 else x.float()


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Random init mirroring the Flax modules': ``lecun_normal`` conv and
    linear weights (fan_in = I * kh * kw), zero biases, unit norm scales,
    running mean 0 / var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
