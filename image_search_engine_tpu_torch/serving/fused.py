"""Serving programs: feature prologue + search core + host epilogue.

Port of the single-device part of ``image_search_engine_tpu/serving/
fused.py``. Every request runs one prologue (upload, preprocess, backbone)
and one search core on the device, then one host transfer in the epilogue.
Families: flat (the certified two-phase top-k; the certificate retry
re-runs the whole dispatch at the wide margin, as in the JAX package), IVF
and IVF-PQ (the probed-scan kernel; IVF-PQ scans a reconstruction table
built once at start, with an optional exact rerank in the same dispatch).
PyTorch runs eagerly, so there is no program to compile and the device
arrays ride in each core's closure. BoVW, micro-batching and the
multi-host coordinator wait for ROADMAP.md (queue 1 items 5, 3 and 7).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.flat import MAX_KERNEL_K, WIDE_MARGIN, faiss_tail
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.ivf import ivf_probed_topk
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


def finish_epilogue(index):
    """Probed-family epilogue: one host transfer of (d, i, ok), invalid
    slots to -1, then the index's Faiss-shaped ``_finish`` (k padding,
    cosine conversion). Probed families carry no certificate, so there is
    no retry."""

    def epilogue(out, k: int, retry):
        del retry
        return index._host_finish([out], k)

    return epilogue


def ivf_family(index):
    """Single-device cell-probe: the probed-scan kernel over the resident
    list-contiguous table (ops/ivf.ivf_probed_topk). The JAX package's
    family runs the XLA gather path here; both score the same probes and
    rows, so results agree modulo ties. Returns (core, statics_fn,
    epilogue)."""
    nprobe = index._effective_nprobe()
    bcents, lists, packed, pnorms = index._device_arrays()

    def core(emb, k, t_margin):
        del t_margin
        return ivf_probed_topk(emb, bcents, packed, pnorms, lists, k, nprobe)

    return core, lambda k: index._k_eff(k, nprobe), finish_epilogue(index)


def ivfpq_family(index):
    """Single-device IVF-PQ: the codes are decompressed once, at engine
    start, into a resident bf16 reconstruction table (scanning it is ADC up
    to bf16 rounding), then the probed-scan kernel and the optional exact
    rerank run in the same dispatch. Returns (core, statics_fn, epilogue);
    the statics are (k_eff, rerank shortlist or 0)."""
    from image_search_engine_tpu_torch.index.ivf import _exact_rescore

    nprobe = index._effective_nprobe()
    pool = nprobe * index.lists.shape[1]
    bcents, lists, _, _, _ = index._device_arrays_pq()
    recon, rnorms = index.recon_table()
    rerank = index.rerank
    if rerank and index.vectors is None:
        log.warning("IVFPQ index configured with rerank=%d but the artifact holds codes "
                    "only — serving ADC-ranked results (rebuild with --pq-rerank to keep "
                    "raw vectors)", rerank)
        rerank = 0
    raw = index.vectors if rerank else None

    def core(emb, statics, t_margin):
        del t_margin
        k, c = statics
        out = ivf_probed_topk(emb, bcents, recon, rnorms, lists, c or k, nprobe)
        if c:
            out = _exact_rescore(emb, raw, out[1], out[2], k)
        return out

    def statics_fn(k):
        k_eff = index._k_eff(k, nprobe)
        return k_eff, (min(max(rerank, k_eff), pool) if rerank else 0)

    return core, statics_fn, finish_epilogue(index)


def wrap_serving(batched_search: BatchedSearch, image_size: int, cfg):
    """The per-request ``search(image, k)``: host resize to the index-build
    resolution on the request's thread, then the dispatch on the device
    thread."""
    from image_search_engine_tpu_torch.serving.http import _resize_host

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
