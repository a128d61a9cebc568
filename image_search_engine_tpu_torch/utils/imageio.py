"""Host-side image IO.

A copy of the JAX package's ``utils/imageio.py``. Decode happens on the host
(PIL, or the C++ loader in the repository's ``native/`` when it builds — see
utils/native_loader.py); everything downstream is device tensors. A thread
pool overlaps decode with device compute.
"""

from __future__ import annotations

import base64
import concurrent.futures as cf
import io
import logging
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

log = logging.getLogger(__name__)

IMAGE_EXTENSIONS = ("*.jpg", "*.jpeg", "*.png")  # reference config.py:36


def get_image_paths(folder: str | Path, extensions: Sequence[str] = IMAGE_EXTENSIONS) -> List[Path]:
    """Recursive glob for corpus images (reference get_images_paths,
    backend/utils.py:222-232), sorted for a deterministic id order."""
    folder = Path(folder)
    paths: List[Path] = []
    for ext in extensions:
        paths.extend(folder.rglob(ext))
        paths.extend(folder.rglob(ext.upper()))
    return sorted(set(paths))


def load_image(path: str | Path, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode one image to RGB float32 [0,1]; optional (H, W) host resize
    (cheap PIL bilinear — the quality-critical resize happens on device)."""
    return load_image_u8(path, size).astype(np.float32) / 255.0


def load_image_u8(path: str | Path, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode one image to RGB uint8 [0,255] (the corpus-loading dtype:
    batches stay uint8 on the host and cast to [0,1] f32 on device —
    ops/image_ops — so uploads move 4x fewer bytes)."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None:
            im = im.resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def decode_image_bytes(data: bytes, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode an uploaded image buffer (reference formdata_file_to_image,
    engine.py:38-43) to RGB float32 [0,1]."""
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        if size is not None:
            im = im.resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def load_images_batched(
    paths: Sequence[str | Path],
    batch_size: int,
    size: Tuple[int, int],
    num_workers: int = 8,
    skip_errors: bool = True,
    use_native: bool = False,
    dtype: str = "u8",
) -> Iterator[Tuple[np.ndarray, List[int]]]:
    """Yield (batch (B, H, W, 3), kept source indices).

    Decoding runs in a thread pool that stays ahead of the consumer;
    unreadable files are skipped with a warning (the reference's per-image
    try/except skip, descriptors.py:81-96). ``use_native=True`` routes
    decode+resize through the C++ loader (native/, GIL-free threads) with
    per-file PIL fallback for formats it doesn't handle.

    ``dtype="u8"`` (default) yields uint8 [0,255] batches — every device
    entry point casts via ops/image_ops, so host->device
    uploads move 4x fewer bytes than pre-divided f32. ``dtype="f32"``
    yields float32 [0,1] (identical values after the device cast).
    """
    if dtype not in ("u8", "f32"):
        raise ValueError(f"dtype must be 'u8' or 'f32', got {dtype!r}")
    one = load_image_u8 if dtype == "u8" else load_image
    paths = list(paths)

    if use_native:
        from image_search_engine_tpu_torch.utils import native_loader

        if native_loader.available():
            nat = (native_loader.load_batch_u8 if dtype == "u8"
                   else native_loader.load_batch)
            for s in range(0, len(paths), batch_size):
                chunk = paths[s : s + batch_size]
                batch, ok = nat(chunk, size[0], size[1], num_workers)
                imgs, idx = [], []
                for j, good in enumerate(ok):
                    if good:
                        imgs.append(batch[j])
                        idx.append(s + j)
                        continue
                    try:  # fallback: e.g. progressive JPEG
                        imgs.append(one(chunk[j], size))
                        idx.append(s + j)
                    except Exception as e:  # noqa: BLE001
                        if not skip_errors:
                            raise
                        log.warning("skipping unreadable image %s: %s", chunk[j], e)
                if imgs:
                    yield np.stack(imgs), idx
            return
        log.warning("native loader unavailable; using PIL thread pool")

    def _load(i: int):
        try:
            return i, one(paths[i], size)
        except Exception as e:  # noqa: BLE001 — any decode failure skips the file
            if not skip_errors:
                raise
            log.warning("skipping unreadable image %s: %s", paths[i], e)
            return i, None

    with cf.ThreadPoolExecutor(num_workers) as pool:
        buf_imgs: List[np.ndarray] = []
        buf_idx: List[int] = []
        for i, img in pool.map(_load, range(len(paths))):
            if img is None:
                continue
            buf_imgs.append(img)
            buf_idx.append(i)
            if len(buf_imgs) == batch_size:
                yield np.stack(buf_imgs), buf_idx
                buf_imgs, buf_idx = [], []
        if buf_imgs:
            yield np.stack(buf_imgs), buf_idx


def thumbnail_b64(path: str | Path, max_size: int = 256) -> str:
    """<=max_size thumbnail as base64 JPEG (PNG fallback for alpha), the
    reference's get_image (backend/utils.py:44-62)."""
    with Image.open(path) as im:
        im.thumbnail((max_size, max_size))
        buf = io.BytesIO()
        try:
            im.convert("RGB").save(buf, format="JPEG", quality=85)
        except OSError:
            buf = io.BytesIO()  # discard any partial JPEG bytes
            im.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode("ascii")


class ThumbnailCache:
    """Precomputed result thumbnails, built once at index time.

    The reference re-opens and re-encodes up to 20 full corpus images with
    PIL on EVERY query (backend/engine.py:59-63, utils.py:44-62) — that is
    the dominant serving cost after the search itself. Here the thumbnails
    are encoded once by the indexer and served from a packed, memory-mapped
    blob: ``data`` (uint8 concat of JPEG/PNG bytes) + ``offsets``
    (int64 N+1), row id i <-> ``paths.csv`` id i.
    """

    def __init__(self, data: np.ndarray, offsets: np.ndarray):
        self._data = data
        self._offsets = offsets

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def get_b64(self, i: int) -> str:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return base64.b64encode(self._data[lo:hi].tobytes()).decode("ascii")

    @classmethod
    def build(
        cls,
        paths: Sequence[str | Path],
        out: str | Path,
        max_size: int = 256,
        num_workers: int = 8,
    ) -> "ThumbnailCache":
        """Encode every corpus image's thumbnail in a thread pool and pack
        them into one .npz. Unreadable files get an empty slot (the engine
        already treats an empty thumbnail as 'missing')."""

        def _encode(p) -> bytes:
            try:
                return base64.b64decode(thumbnail_b64(p, max_size))
            except Exception as e:  # noqa: BLE001 — missing/corrupt corpus file
                log.warning("thumbnail skipped for %s: %s", p, e)
                return b""

        with cf.ThreadPoolExecutor(num_workers) as pool:
            blobs = list(pool.map(_encode, paths))
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        data = np.frombuffer(b"".join(blobs), np.uint8)
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, data=data, offsets=offsets)
        return cls(data, offsets)

    @classmethod
    def load(cls, src: str | Path) -> "ThumbnailCache":
        z = np.load(src, allow_pickle=False)
        return cls(z["data"], z["offsets"])


def save_paths_csv(paths: Sequence[str | Path], out: str | Path) -> None:
    """id -> path sidecar (reference save_images_df, siamese/utils.py:57-70)."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write("id,path\n")
        for i, p in enumerate(paths):
            f.write(f"{i},{p}\n")


def load_paths_csv(src: str | Path) -> List[str]:
    lines = Path(src).read_text().splitlines()[1:]
    return [ln.split(",", 1)[1] for ln in lines if ln]


def chunk_evenly(seq: Sequence, n: int) -> List[Sequence]:
    """Split into n near-equal chunks (reference chunkIt, utils.py:29-41)."""
    n = max(1, min(n, len(seq)))
    avg = len(seq) / n
    out = []
    last = 0.0
    while last < len(seq):
        out.append(seq[int(last) : int(last + avg)])
        last += avg
    return out
