"""Device-resident vector store: the array substrate under the flat index.

Port of ``image_search_engine_tpu/index/store.py``: an (Npad, d) tensor on
the device, its squared norms with ``PAD_NORM`` at the padding rows
(validity carried in data, see parallel/topk.py), and the valid row count.
The store dtype trades memory for recall against the f32 rows:

  * "f32"  — exact, 4 bytes per dimension;
  * "bf16" — 2 bytes; search is exact over the rounded store;
  * "int8" — 1 byte, symmetric per-row quantization with an f32 dequant
    scale per row (``scales``); search is exact over the quantized store.

Norms are computed in float64 from the store values themselves (bf16-rounded,
or dequantized for int8), so every search phase scores one consistent set of
vectors. Row sharding waits for ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import round_up
from image_search_engine_tpu_torch.ops.topk import quantize_int8
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM
from image_search_engine_tpu_torch.utils.device import resolve_device

STORE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_ROW_CHUNK = 1 << 14  # rows per pass of the norm and quantization loops (bounds temporaries)


def check_store_dtype(dtype: str) -> torch.dtype:
    if dtype not in STORE_DTYPES:
        raise ValueError(f"store dtype must be one of {sorted(STORE_DTYPES)}, got {dtype!r}")
    return STORE_DTYPES[dtype]


def _sq_norms(v: torch.Tensor, scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float64 squared norms of the rows of ``v``, or of the f32 dequantized
    rows ``v * scales[:, None]`` when scales are given, as f32."""
    out = torch.empty(v.shape[0], dtype=torch.float32, device=v.device)
    for s in range(0, v.shape[0], _ROW_CHUNK):
        rows = v[s:s + _ROW_CHUNK]
        if scales is not None:
            rows = rows.float() * scales[s:s + _ROW_CHUNK, None]
        out[s:s + _ROW_CHUNK] = rows.double().pow(2).sum(1).float()
    return out


def quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization on x's device, in row chunks: (codes int8,
    scales f32), bit-identical to the JAX package's ``quantize_rows_int8``
    (ops/topk.quantize_int8). Requantizing dequantized codes is exact: the
    row's amax dequantizes to scale * 127, so the scale and every code come
    back the same (a zero row: scale 1e-12 / 127, zero codes, again)."""
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _ROW_CHUNK):
        codes[s:s + _ROW_CHUNK], scales[s:s + _ROW_CHUNK] = quantize_int8(x[s:s + _ROW_CHUNK])
    return codes, scales


@dataclasses.dataclass
class VectorStore:
    vectors: torch.Tensor  # (Npad, d) float32 / bfloat16 / int8 codes
    norms: torch.Tensor  # (Npad,) float32 squared norms; PAD_NORM on pad rows
    n: int  # valid rows
    dtype: str = "f32"
    scales: Optional[torch.Tensor] = None  # (Npad,) f32 dequant scales (int8 only); 0 on pad rows

    @property
    def n_padded(self) -> int:
        return self.vectors.shape[0]

    @classmethod
    def build(cls, x, pad_multiple: int = 8, dtype: str = "f32",
              device: str | torch.device = "cuda") -> "VectorStore":
        """Build from f32 rows (numpy array or tensor); pads to
        ``pad_multiple`` rows with zero vectors whose norms are poisoned."""
        tdt = check_store_dtype(dtype)
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        if dtype == "int8":
            return cls.from_quantized(*quantize_rows_int8(x), pad_multiple=pad_multiple,
                                      device=dev)
        n = x.shape[0]
        npad = round_up(max(n, 1), pad_multiple)
        if npad != n:
            x = F.pad(x, (0, 0, 0, npad - n))
        store = x.to(tdt).contiguous()
        norms = torch.full((npad,), PAD_NORM, dtype=torch.float32, device=dev)
        norms[:n] = _sq_norms(store[:n])
        return cls(vectors=store, norms=norms, n=n, dtype=dtype)

    @classmethod
    def from_quantized(cls, codes, scales, pad_multiple: int = 8,
                       device: str | torch.device = "cuda") -> "VectorStore":
        """An int8 store straight from (codes (N, d), scales (N,)), with no
        dequantize/requantize round trip (the index load path). Pad rows get
        code 0, scale 0 and PAD_NORM."""
        dev = resolve_device(device)
        codes = torch.as_tensor(codes).to(device=dev, dtype=torch.int8)
        scales = torch.as_tensor(scales).to(device=dev, dtype=torch.float32)
        n, d = codes.shape
        npad = round_up(max(n, 1), pad_multiple)
        cp = torch.zeros((npad, d), dtype=torch.int8, device=dev)
        cp[:n] = codes
        sp = torch.zeros(npad, dtype=torch.float32, device=dev)
        sp[:n] = scales
        norms = torch.full((npad,), PAD_NORM, dtype=torch.float32, device=dev)
        norms[:n] = _sq_norms(codes, scales)
        return cls(vectors=cp, norms=norms, n=n, dtype="int8", scales=sp)

    def values(self) -> torch.Tensor:
        """Valid rows as f32 on the device (dequantized for int8: the exact
        store values, which requantize to the same codes)."""
        v = self.vectors[: self.n].float()
        return v if self.scales is None else v * self.scales[: self.n, None]

    def to_host(self) -> np.ndarray:
        """Valid rows as a host f32 array (exact for bf16 and int8)."""
        return self.values().cpu().numpy()

    def to_host_raw(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Valid rows in the store dtype plus the scales (int8; else None)
        for serialization; bf16 comes back as its uint16 bit pattern (numpy
        has no bfloat16)."""
        v = self.vectors[: self.n].cpu()
        s = None if self.scales is None else self.scales[: self.n].cpu().numpy()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), s
        return v.numpy(), s
