"""Backbone weights for the port's ResNet, DenseNet, BiT and the siamese net.

Two sources:

  * a ``.pth`` in the layout of its origin (``--torch-weights``): the port's
    ResNet and DenseNet use torchvision's parameter names and its BiT
    HuggingFace ``BitModel``'s, so the checkpoint loads straight in
    (:func:`load_torch_weights`; a ``bit.`` prefix, as
    ``BitForImageClassification`` writes it, is stripped, and classifier
    heads and ``pooler.*`` are left out);
  * the JAX package's Flax variables (``params`` / ``batch_stats`` as numpy
    trees): :func:`state_dict_from_flax` is the inverse of the JAX
    package's ``models/torch_import.py`` converters
    (``convert_torchvision_resnet``, ``convert_torchvision_densenet``,
    ``convert_hf_bit``), and carries the siamese ``EmbeddingNet``'s head
    too (conv kernel (H, W, I, O) -> (O, I, H, W); Dense kernel (I, O) ->
    Linear weight (O, I); BN and GroupNorm scale/bias -> weight/bias;
    batch_stats mean/var -> running_mean/running_var).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

#: classifier heads and poolers of the source checkpoints, which the
#: backbones leave out
_HEAD_PREFIXES = ("fc.", "classifier.", "pooler.")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None,
                         stage_sizes: Sequence[int],
                         arch: str = "resnet") -> Dict[str, torch.Tensor]:
    """Flax variables -> the port's state dict. ``arch``: "resnet"
    (``stage_sizes`` its stages), "densenet" (its blocks), "bit" (its
    stages; ``batch_stats`` None: GroupNorm keeps none) or "siamese" (an
    ``EmbeddingNet`` over the DenseNet of blocks ``stage_sizes``: the
    backbone under ``backbone.``, the head's ``fc0..fc3`` and ``bn0..bn2``)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst: str, p) -> None:
        sd[f"{dst}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def dense(dst: str, p) -> None:
        sd[f"{dst}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{dst}.bias"] = _t(p["bias"])

    def norm(dst: str, p, s=None) -> None:
        sd[f"{dst}.weight"] = _t(p["scale"])
        sd[f"{dst}.bias"] = _t(p["bias"])
        if s is not None:
            sd[f"{dst}.running_mean"] = _t(s["mean"])
            sd[f"{dst}.running_var"] = _t(s["var"])

    def resnet(p, s) -> None:
        conv("conv1", p["Conv_0"])
        norm("bn1", p["BatchNorm_0"], s["BatchNorm_0"])
        b = 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                src_p, src_s = p[f"Bottleneck_{b}"], s[f"Bottleneck_{b}"]
                dst = f"layer{i + 1}.{j}"
                for c in range(3):
                    conv(f"{dst}.conv{c + 1}", src_p[f"Conv_{c}"])
                    norm(f"{dst}.bn{c + 1}", src_p[f"BatchNorm_{c}"], src_s[f"BatchNorm_{c}"])
                if "Conv_3" in src_p:
                    conv(f"{dst}.downsample.0", src_p["Conv_3"])
                    norm(f"{dst}.downsample.1", src_p["BatchNorm_3"], src_s["BatchNorm_3"])
                b += 1

    def densenet(p, s, pre: str = "") -> None:
        f = pre + "features"
        conv(f"{f}.conv0", p["Conv_0"])
        norm(f"{f}.norm0", p["BatchNorm_0"], s["BatchNorm_0"])
        dl = 0  # Flax numbers the DenseLayers across all blocks
        for b, n_layers in enumerate(stage_sizes):
            for l in range(n_layers):
                src_p, src_s = p[f"DenseLayer_{dl}"], s[f"DenseLayer_{dl}"]
                dst = f"{f}.denseblock{b + 1}.denselayer{l + 1}"
                norm(f"{dst}.norm1", src_p["BatchNorm_0"], src_s["BatchNorm_0"])
                conv(f"{dst}.conv1", src_p["Conv_0"])
                norm(f"{dst}.norm2", src_p["BatchNorm_1"], src_s["BatchNorm_1"])
                conv(f"{dst}.conv2", src_p["Conv_1"])
                dl += 1
            if b != len(stage_sizes) - 1:
                src_p, src_s = p[f"Transition_{b}"], s[f"Transition_{b}"]
                norm(f"{f}.transition{b + 1}.norm", src_p["BatchNorm_0"], src_s["BatchNorm_0"])
                conv(f"{f}.transition{b + 1}.conv", src_p["Conv_0"])
        norm(f"{f}.norm5", p["BatchNorm_1"], s["BatchNorm_1"])

    def bit(p) -> None:
        conv("embedder.convolution", p["StdConv_0"])
        b = 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                src = p[f"PreActBottleneck_{b}"]
                dst = f"encoder.stages.{i}.layers.{j}"
                c = 0
                if "StdConv_3" in src:  # the shortcut's conv was made first
                    conv(f"{dst}.downsample.conv", src["StdConv_0"])
                    c = 1
                for n in range(3):
                    norm(f"{dst}.norm{n + 1}", src[f"GroupNorm_{n}"])
                    conv(f"{dst}.conv{n + 1}", src[f"StdConv_{c + n}"])
                b += 1
        norm("norm", p["GroupNorm_0"])

    if arch == "resnet":
        resnet(params, batch_stats)
    elif arch == "densenet":
        densenet(params, batch_stats)
    elif arch == "bit":
        bit(params)
    elif arch == "siamese":
        name = next(k for k in params if k.startswith("DenseNet"))
        densenet(params[name], batch_stats[name], "backbone.")
        for i in range(4):
            dense(f"fc{i}", params[f"Dense_{i}"])
        for i in range(3):
            norm(f"bn{i}", params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"])
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return sd


def read_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """A .pth/.pt checkpoint on the CPU, unwrapped from {'state_dict': ...}
    / {'model': ...} nesting and DataParallel ``module.`` prefixes."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            blob = blob[key]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in blob.items()}


def backbone_keys(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` without its classifier head, pooler and BN step counters; a
    ``bit.``-prefixed checkpoint (HF ``BitForImageClassification``) keeps
    only its ``bit.`` keys, unprefixed, as the JAX package's import does."""
    if any(k.startswith("bit.") for k in sd):
        sd = {k[len("bit."):]: v for k, v in sd.items() if k.startswith("bit.")}
    return {k: v for k, v in sd.items()
            if not k.startswith(_HEAD_PREFIXES) and not k.endswith("num_batches_tracked")}


def load_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``model``: every parameter and running statistic
    must be present, and nothing beyond the classifier head, the pooler and
    BN step counters may be left over (a deeper checkpoint must not
    half-load)."""
    sd = backbone_keys(sd)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"checkpoint does not match the architecture: missing {missing[:6]}, "
            f"unexpected {unexpected[:6]}")


def load_torch_weights(model: nn.Module, path: str | Path) -> None:
    """Load a checkpoint file (torchvision ResNet / DenseNet, HF BiT
    layout) into ``model``."""
    load_state_dict(model, read_state_dict(path))
