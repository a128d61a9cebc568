"""Device-resident vector store: the array substrate under the flat index.

Port of ``image_search_engine_tpu/index/store.py`` for f32 and bf16 stores:
an (Npad, d) tensor on the device, its squared norms with ``PAD_NORM`` at
the padding rows (validity carried in data, see parallel/topk.py), and the
valid row count. Norms are computed in float64 from the store values
themselves (bf16-rounded for a bf16 store), so every search phase scores
one consistent set of vectors. The int8 store and row sharding wait for
ROADMAP.md (queue 2 item 4; queue 1 item 7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import round_up
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM
from image_search_engine_tpu_torch.utils.device import resolve_device
from image_search_engine_tpu_torch.utils.unported import not_ported

STORE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_NORM_CHUNK = 1 << 14  # rows per float64 norm pass (bounds the f64 temporary)


def check_store_dtype(dtype: str) -> torch.dtype:
    if dtype == "int8":
        raise not_ported("the int8 store", "int8")
    if dtype not in STORE_DTYPES:
        raise ValueError(f"store dtype must be one of {sorted(STORE_DTYPES)}, got {dtype!r}")
    return STORE_DTYPES[dtype]


def _sq_norms(v: torch.Tensor) -> torch.Tensor:
    out = torch.empty(v.shape[0], dtype=torch.float32, device=v.device)
    for s in range(0, v.shape[0], _NORM_CHUNK):
        out[s:s + _NORM_CHUNK] = v[s:s + _NORM_CHUNK].double().pow(2).sum(1).float()
    return out


@dataclasses.dataclass
class VectorStore:
    vectors: torch.Tensor  # (Npad, d) float32 / bfloat16
    norms: torch.Tensor  # (Npad,) float32 squared norms; PAD_NORM on pad rows
    n: int  # valid rows
    dtype: str = "f32"

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
        n = x.shape[0]
        npad = round_up(max(n, 1), pad_multiple)
        if npad != n:
            x = F.pad(x, (0, 0, 0, npad - n))
        store = x.to(tdt).contiguous()
        norms = torch.full((npad,), PAD_NORM, dtype=torch.float32, device=dev)
        norms[:n] = _sq_norms(store[:n])
        return cls(vectors=store, norms=norms, n=n, dtype=dtype)

    def to_host(self) -> np.ndarray:
        """Valid rows as a host f32 array (exact for bf16)."""
        return self.vectors[: self.n].float().cpu().numpy()

    def to_host_raw(self) -> np.ndarray:
        """Valid rows in the store dtype for serialization; bf16 comes back
        as its uint16 bit pattern (numpy has no bfloat16)."""
        v = self.vectors[: self.n].cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
