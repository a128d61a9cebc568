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
vectors. On a mesh (parallel/mesh.py) the store is padded to a multiple of
``lcm(pad_multiple, S)`` rows and split into S row blocks; ``vectors``,
``norms`` and ``scales`` then hold this process's blocks, each on its
shard's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import round_up
from image_search_engine_tpu_torch.ops.topk import quantize_int8
from image_search_engine_tpu_torch.parallel.mesh import Mesh, shard_rows
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
    vectors: torch.Tensor  # (Npad, d) float32 / bfloat16 / int8 codes; on a mesh, blocks
    norms: torch.Tensor  # (Npad,) float32 squared norms; PAD_NORM on pad rows
    n: int  # valid rows
    dtype: str = "f32"
    scales: Optional[torch.Tensor] = None  # (Npad,) f32 dequant scales (int8 only); 0 on pad rows
    mesh: Optional[Mesh] = None  # set: the three tensors are this process's row blocks

    @property
    def n_padded(self) -> int:
        if self.mesh is None:
            return self.vectors.shape[0]
        return self.vectors[0].shape[0] * self.mesh.size

    @staticmethod
    def _npad(n: int, pad_multiple: int, mesh: Optional[Mesh]) -> int:
        mult = pad_multiple if mesh is None else math.lcm(pad_multiple, mesh.size)
        return round_up(max(n, 1), mult)

    @classmethod
    def build(cls, x, pad_multiple: int = 8, dtype: str = "f32",
              device: str | torch.device = "cuda", mesh: Optional[Mesh] = None) -> "VectorStore":
        """Build from f32 rows (numpy array or tensor); pads with zero
        vectors whose norms are poisoned, to ``pad_multiple`` rows, or on a
        mesh to ``lcm(pad_multiple, S)`` rows split over the shards (then
        ``device`` is the mesh's home device)."""
        tdt = check_store_dtype(dtype)
        dev = mesh.home if mesh is not None else resolve_device(device)
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        if dtype == "int8":
            return cls.from_quantized(*quantize_rows_int8(x), pad_multiple=pad_multiple,
                                      device=dev, mesh=mesh)
        n = x.shape[0]
        npad = cls._npad(n, pad_multiple, mesh)
        if npad != n:
            x = F.pad(x, (0, 0, 0, npad - n))
        store = x.to(tdt).contiguous()
        norms = torch.full((npad,), PAD_NORM, dtype=torch.float32, device=dev)
        norms[:n] = _sq_norms(store[:n])
        return cls(vectors=store, norms=norms, n=n, dtype=dtype)._place(mesh)

    @classmethod
    def from_quantized(cls, codes, scales, pad_multiple: int = 8,
                       device: str | torch.device = "cuda",
                       mesh: Optional[Mesh] = None) -> "VectorStore":
        """An int8 store straight from (codes (N, d), scales (N,)), with no
        dequantize/requantize round trip (the index load path). Pad rows get
        code 0, scale 0 and PAD_NORM."""
        dev = mesh.home if mesh is not None else resolve_device(device)
        codes = torch.as_tensor(codes).to(device=dev, dtype=torch.int8)
        scales = torch.as_tensor(scales).to(device=dev, dtype=torch.float32)
        n, d = codes.shape
        npad = cls._npad(n, pad_multiple, mesh)
        cp = torch.zeros((npad, d), dtype=torch.int8, device=dev)
        cp[:n] = codes
        sp = torch.zeros(npad, dtype=torch.float32, device=dev)
        sp[:n] = scales
        norms = torch.full((npad,), PAD_NORM, dtype=torch.float32, device=dev)
        norms[:n] = _sq_norms(codes, scales)
        return cls(vectors=cp, norms=norms, n=n, dtype="int8", scales=sp)._place(mesh)

    def _place(self, mesh: Optional[Mesh]) -> "VectorStore":
        """Split the padded tensors into the mesh's row blocks."""
        if mesh is not None:
            self.vectors, self.norms = shard_rows(self.vectors, mesh), shard_rows(self.norms, mesh)
            if self.scales is not None:
                self.scales = shard_rows(self.scales, mesh)
            self.mesh = mesh
        return self

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """The valid rows of ``t`` (on a mesh: its blocks joined on the
        home device; a mesh over processes holds only this process's)."""
        if self.mesh is None:
            return t[: self.n]
        if self.mesh.world > 1:
            raise ValueError("a store sharded over processes holds only this process's rows")
        return torch.cat([b.to(self.mesh.home) for b in t])[: self.n]

    def values(self) -> torch.Tensor:
        """Valid rows as f32 on the device (dequantized for int8: the exact
        store values, which requantize to the same codes)."""
        v = self._rows(self.vectors).float()
        return v if self.scales is None else v * self._rows(self.scales)[:, None]

    def to_host(self) -> np.ndarray:
        """Valid rows as a host f32 array (exact for bf16 and int8)."""
        return self.values().cpu().numpy()

    def to_host_raw(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Valid rows in the store dtype plus the scales (int8; else None)
        for serialization; bf16 comes back as its uint16 bit pattern (numpy
        has no bfloat16)."""
        v = self._rows(self.vectors).cpu()
        s = None if self.scales is None else self._rows(self.scales).cpu().numpy()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), s
        return v.numpy(), s
