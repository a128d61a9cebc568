"""Serving programs: feature prologue + search core + host epilogue.

Port of the DNN-flat part of ``image_search_engine_tpu/serving/fused.py``.
Every request runs one prologue (upload, preprocess, backbone) and one
search core (the certified two-phase top-k) on the device, then one host
transfer of (distances, ids, certificate) in the epilogue. PyTorch runs
eagerly, so there is no program to compile and the store rides in the
core's closure; the structure is kept so that the certificate retry
re-runs the whole dispatch at the wide margin, as in the JAX package. The
IVF, IVF-PQ and BoVW families, micro-batching and the multi-host
coordinator wait for ROADMAP.md (queue 1 items 4, 5, 3 and 7).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.flat import MAX_KERNEL_K, WIDE_MARGIN, faiss_tail
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.parallel.topk import local_topk_with_norms
from image_search_engine_tpu_torch.utils.unported import not_ported

log = logging.getLogger(__name__)

BatchedSearch = Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def make_batched_search(prologue: Callable, core: Callable,
                        statics_fn: Callable[[int], int],
                        epilogue: Callable) -> BatchedSearch:
    """Compose ``prologue(images) -> feats`` and ``core(feats, k,
    t_margin) -> out`` into one dispatch, wrapped by the family's
    ``epilogue(out, k, retry) -> (d, i)``; ``statics_fn(k)`` clamps k to
    the candidate pool."""

    @torch.inference_mode()
    def dispatch(images: np.ndarray, k: int, t_margin=None):
        return core(prologue(images), statics_fn(k), t_margin)

    def batched_search(images: np.ndarray, k: int):
        def retry(t_margin=None):
            return dispatch(images, k, t_margin)

        return epilogue(retry(), k, retry)

    return batched_search


def certificate_epilogue(descending: bool, stats=None, label: str = ""):
    """Exact-search epilogue: one host transfer of (d, i, cert); on a
    certificate failure re-run the dispatch once at the wide margin and
    count the escalation; then pad the Faiss-shaped (-1, worst) tail when k
    exceeds the candidate pool."""

    def epilogue(out, k: int, retry):
        d, i, cert = (t.cpu().numpy() for t in out)
        if not cert.all():
            n_fail = int((~cert).sum())
            log.warning("%stop-k certificate failed for %d queries; "
                        "re-running at wide margin", label, n_fail)
            if stats is not None:
                stats.record_escalation(n_fail)
            d, i, cert2 = (t.cpu().numpy() for t in retry(t_margin=WIDE_MARGIN))
            if not cert2.all():
                n_still = int((~cert2).sum())
                log.error("%stop-k certificate STILL failing for %d queries at "
                          "wide margin %d — serving best-effort results",
                          label, n_still, WIDE_MARGIN)
                if stats is not None:
                    stats.record_escalation(n_still)
        return faiss_tail(d, i, k, descending)

    return epilogue


def cnn_prologue(embedder, normalize: bool):
    """CNN embed prologue: upload -> preprocess -> backbone -> optional
    l2-normalize. Images arrive resized to the index-build resolution
    (``wrap_serving``)."""

    def prologue(images: np.ndarray) -> torch.Tensor:
        emb = embedder.embed(torch.as_tensor(images).to(embedder.device))
        return l2_normalize(emb) if normalize else emb

    return prologue


def flat_family(index, stats=None, label: str = ""):
    """Exact flat search core: the two-phase kernels for k <= 128, the
    plain full scan past that (the index/flat.py rule). Emits the
    certificate either way (the full scan's is True by construction).
    Returns (core, statics_fn, epilogue)."""
    search_metric = "ip" if index.metric in ("ip", "cosine") else index.metric
    store, norms, n_valid = index.store.vectors, index.store.norms, index.store.n

    def core(emb, k, t_margin):
        return local_topk_with_norms(
            emb, store, norms, k, search_metric, use_kernels=k <= MAX_KERNEL_K,
            with_certificate=True, t_margin=t_margin)

    epilogue = certificate_epilogue(descending=search_metric == "ip", stats=stats, label=label)
    return core, lambda k: min(k, n_valid), epilogue


def wrap_serving(batched_search: BatchedSearch, image_size: int, cfg):
    """The per-request ``search(image, k)``: host resize to the index-build
    resolution on the request's thread, then the dispatch on the device
    thread."""
    from image_search_engine_tpu.engine import _resize_host

    if cfg.micro_batch_mode() != "off":
        raise not_ported(f"--micro-batch {cfg.micro_batch_mode()}", "serving")
    # Device work runs on one long-lived thread: PyTorch caches cuDNN
    # execution plans per thread, and the HTTP server starts a thread per
    # request, which would re-plan every convolution each time.
    device_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")

    def search(image: np.ndarray, k: int):
        images = _resize_host(image, image_size)[None]
        return device_thread.submit(batched_search, images, k).result()

    return search
