"""Backbone weights for the port's ResNet.

Two sources:

  * a torchvision-layout ``.pth`` (``--torch-weights``): the port's ResNet
    uses torchvision's parameter names, so the checkpoint loads straight
    in (:func:`load_torch_weights`);
  * the JAX package's Flax variables (``params`` / ``batch_stats`` as numpy
    trees): :func:`state_dict_from_flax` is the inverse of
    ``image_search_engine_tpu.models.torch_import.convert_torchvision_resnet``
    (conv kernel (H, W, I, O) -> (O, I, H, W); BN scale/bias -> weight/bias;
    batch_stats mean/var -> running_mean/running_var).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

_HEAD_KEYS = ("fc.weight", "fc.bias")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         stage_sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Flax ResNet variables -> the port's (torchvision-named) state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst: str, p) -> None:
        sd[f"{dst}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(dst: str, p, s) -> None:
        sd[f"{dst}.weight"] = _t(p["scale"])
        sd[f"{dst}.bias"] = _t(p["bias"])
        sd[f"{dst}.running_mean"] = _t(s["mean"])
        sd[f"{dst}.running_var"] = _t(s["var"])

    conv("conv1", params["Conv_0"])
    bn("bn1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    b = 0
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            src_p, src_s = params[f"Bottleneck_{b}"], batch_stats[f"Bottleneck_{b}"]
            dst = f"layer{i + 1}.{j}"
            for c in range(3):
                conv(f"{dst}.conv{c + 1}", src_p[f"Conv_{c}"])
                bn(f"{dst}.bn{c + 1}", src_p[f"BatchNorm_{c}"], src_s[f"BatchNorm_{c}"])
            if "Conv_3" in src_p:
                conv(f"{dst}.downsample.0", src_p["Conv_3"])
                bn(f"{dst}.downsample.1", src_p["BatchNorm_3"], src_s["BatchNorm_3"])
            b += 1
    return sd


def read_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """A .pth/.pt checkpoint on the CPU, unwrapped from {'state_dict': ...}
    / {'model': ...} nesting and DataParallel ``module.`` prefixes."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            blob = blob[key]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in blob.items()}


def load_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``model``: every parameter and running statistic
    must be present, and nothing beyond the classifier head and BN step
    counters may be left over (a deeper checkpoint must not half-load)."""
    sd = {k: v for k, v in sd.items()
          if k not in _HEAD_KEYS and not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"checkpoint does not match the architecture: missing {missing[:6]}, "
            f"unexpected {unexpected[:6]}")


def load_torch_weights(model: nn.Module, path: str | Path) -> None:
    """Load a torchvision-layout ResNet checkpoint file into ``model``."""
    load_state_dict(model, read_state_dict(path))
