"""Request micro-batching.

Port of ``image_search_engine_tpu/serving/batching.py``, same semantics:
concurrent queries are collected for a few milliseconds and run as ONE
padded device batch, so under load the card sees one batch-B dispatch
instead of B batch-1 dispatches. Batch sizes are padded to a two-size
ladder because each batch size is its own captured program
(``serving/fused.make_batched_search`` keys its CUDA graphs on the batch
shape).

In the port every device call runs on the serving path's one device thread
(``serving/fused.wrap_serving``), so the ``batched_search`` handed to this
module is that thread's entry: the batcher's worker hands each batch to the
device thread, and the calibration's "independent" side submits its B = 1
requests through the same thread, as serving does with batching off.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

BatchedSearch = Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def pad_to_ladder(n: int, max_batch: int) -> int:
    """Two-program ladder: singletons stay at 1, anything else pads to
    ``max_batch``. Each distinct batch size is a separate captured program,
    so the ladder bounds the captures (and their graph memory) to two."""
    return 1 if n <= 1 else max_batch


def measure_micro_batch_gain(batched_search: BatchedSearch, image_shape: Tuple[int, ...],
                             k: int, max_batch: int, reps: int = 3) -> Tuple[float, float]:
    """Measure whether coalescing pays on the host that serves.

    Micro-batching trades per-dispatch overhead (amortized over B riders)
    against a collect wait, but independent dispatches also pipeline:
    while the device runs one request's program, the host resizes and
    queues the next. Whether coalescing wins is a property of the serving
    host, so ``--micro-batch auto`` measures it: ``max_batch`` independent
    B = 1 searches from ``max_batch`` threads (the no-batcher serving
    shape) against one padded B = ``max_batch`` search, both warm.

    Returns ``(threaded_ms_per_query, batched_ms_per_query)``, the best of
    ``reps`` runs for each side (the min filters scheduler noise; both
    sides get the same treatment).
    """
    img1 = np.zeros((1, *image_shape), np.float32)
    imgb = np.zeros((max_batch, *image_shape), np.float32)
    # warm both programs so neither side's timing includes a capture
    batched_search(img1, k)
    batched_search(imgb, k)

    threaded: List[float] = []
    for _ in range(reps):
        # threads are created and started outside the timed region, parked
        # on an Event: thread start-up has no counterpart on the batched
        # side. An exception inside a thread is re-raised after the join,
        # so a failing B = 1 dispatch fails the calibration instead of
        # reading as an artificially fast "threaded" time.
        errors: List[BaseException] = []
        release = threading.Event()

        def target():
            release.wait()
            try:
                batched_search(img1, k)
            except BaseException as e:  # noqa: BLE001 — re-raised after the join
                errors.append(e)

        threads = [threading.Thread(target=target) for _ in range(max_batch)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        release.set()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        threaded.append(dt / max_batch * 1e3)

    batched: List[float] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        batched_search(imgb, k)
        batched.append((time.perf_counter() - t0) / max_batch * 1e3)

    return min(threaded), min(batched)


def micro_batch_pays(threaded_ms: float, batched_ms: float, margin: float = 0.9) -> bool:
    """Decision rule for ``--micro-batch auto``: coalescing must beat the
    independent dispatches by more than 10% per query to justify the
    batcher's collect wait (``max_wait_ms`` of added latency under low
    load); a tie goes to the simpler per-request path."""
    return batched_ms < threaded_ms * margin


@dataclass
class _Pending:
    image: np.ndarray
    k: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, np.ndarray]] = None
    error: Optional[Exception] = None


class MicroBatcher:
    """Wraps a batched search with a collect-then-execute loop.

    Args:
      batched_search: fn(images (B, H, W, 3) f32, k) -> (dists (B, k'),
        ids (B, k')); called with B = 1 or ``max_batch`` only.
      max_batch: largest batch to collect (also the padded batch size of
        any batch of more than one request).
      max_wait_ms: how long the collector waits for co-riders after the
        first request arrives (the latency cost under low load).
    """

    def __init__(self, batched_search: BatchedSearch, max_batch: int = 8,
                 max_wait_ms: float = 3.0):
        self._fn = batched_search
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, name="micro-batcher", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------
    def search(self, image: np.ndarray, k: int, timeout: float = 300.0):
        """One (H, W, 3) image's (dists (1, k), ids (1, k)), from whichever
        batch it rode; raises the batch's error, or TimeoutError."""
        p = _Pending(image=image, k=k)
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("micro-batched search timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        """Stop the worker (after the batch it is running, if any)."""
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=2)

    # -- worker --------------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                nxt = self._q.get(timeout=self.max_wait_s)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                k = max(p.k for p in batch)
                b = pad_to_ladder(len(batch), self.max_batch)
                images = np.stack([p.image for p in batch]
                                  + [np.zeros_like(batch[0].image)] * (b - len(batch)))
                dists, ids = self._fn(images, k)
                for j, p in enumerate(batch):
                    p.result = (dists[j:j + 1, :p.k], ids[j:j + 1, :p.k])
                    p.event.set()
            except Exception as e:  # noqa: BLE001 — propagate to every rider
                for p in batch:
                    p.error = e
                    p.event.set()
