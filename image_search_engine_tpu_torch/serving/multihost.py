"""Multi-process serving: the broadcast-dispatch worker loop.

Port of ``image_search_engine_tpu/serving/multihost.py``. On a mesh over
processes every process must run every collective, in the same order. An
HTTP query lands on process 0 only; left alone, its sharded search would
wait forever for the other processes' candidates. So:

  * process 0 broadcasts one fixed-shape message per dispatch over the
    default (gloo) process group, a header ``[opcode, b, k, t_margin]``
    then, for a query, the batch padded to ``(max_batch, s, s, 3)``, and
    then runs the dispatch;
  * processes > 0 wait in :func:`worker_loop`: receive the message, run
    the same dispatch (same statics, from the same header and artifacts),
    discard the result;
  * a sentinel header ends the workers' loops.

Correctness rests on two invariants. (1) Order: the coordinator's lock
covers the broadcast and the dispatch on process 0, so the broadcast
order is process 0's dispatch order, and the single-threaded worker
follows it. (2) Determinism of everything else: every process loads the
same artifacts and flags, so the families, statics and shapes agree by
construction. The certificate retry needs no second protocol: process 0's
epilogue dispatches again through the same hooked path, which broadcasts
again, and the worker follows; the worker never reads certificates.

Every wait for a peer is bounded by the process group's timeout
(parallel/mesh.init_multihost). So that an idle server's workers do not
time out, process 0 broadcasts a heartbeat header when nothing has been
sent for ``HEARTBEAT_S`` seconds; a worker that hears nothing for the
timeout raises instead of hanging, and so does process 0 when a worker
has gone.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

OP_SHUTDOWN = 0.0
OP_QUERY = 1.0
OP_HEARTBEAT = 2.0

#: header layout: [opcode, real row count b, k, t_margin (-1 = default)]
_HEADER_LEN = 4

#: seconds of silence after which process 0 broadcasts a heartbeat
HEARTBEAT_S = 10.0


class MultihostCoordinator:
    """The per-dispatch broadcast protocol between process 0 (the HTTP
    server) and the worker processes.

    Construct it the same way in every process (shapes come from the shared
    config and artifacts). Process 0 calls :meth:`announce` under
    :attr:`lock` before every dispatch and :meth:`shutdown` once at exit,
    and keeps the workers' waits short with heartbeats; workers call
    :meth:`receive` in :func:`worker_loop`."""

    def __init__(self, max_batch: int, image_size: int):
        self.max_batch = int(max_batch)
        self.image_size = int(image_size)
        self.batch_shape = (self.max_batch, self.image_size, self.image_size, 3)
        #: serializes broadcast + dispatch on process 0, so the workers see
        #: one order even under concurrent HTTP threads
        self.lock = threading.Lock()
        self._last_send = time.monotonic()
        self._stop = threading.Event()
        self._beat = None
        if dist.get_rank() == 0:
            self._beat = threading.Thread(target=self._heartbeat, args=(HEARTBEAT_S,),
                                          name="multihost-heartbeat", daemon=True)
            self._beat.start()

    # -- wire format ---------------------------------------------------------
    def _send(self, header: np.ndarray, batch: Optional[np.ndarray] = None) -> None:
        dist.broadcast(torch.from_numpy(header), src=0)
        if batch is not None:
            dist.broadcast(torch.from_numpy(batch), src=0)
        self._last_send = time.monotonic()

    def _heartbeat(self, every: float) -> None:
        while not self._stop.wait(every):
            with self.lock:
                if self._stop.is_set():
                    return
                if time.monotonic() - self._last_send < every:
                    continue
                try:
                    self._send(np.array([OP_HEARTBEAT, 0, 0, -1], np.float32))
                except RuntimeError:
                    log.exception("multi-process heartbeat failed; the next dispatch "
                                  "will raise")
                    return

    def announce(self, images: np.ndarray, k: int, t_margin: Optional[int]) -> None:
        """Process 0: publish the next dispatch (under ``lock``, just before
        running it)."""
        images = np.asarray(images, np.float32)
        b = images.shape[0]
        if b > self.max_batch:
            raise ValueError(f"dispatch batch {b} exceeds the multi-host broadcast shape "
                             f"{self.max_batch} (raise micro_batch_max)")
        batch = np.zeros(self.batch_shape, np.float32)
        batch[:b] = images
        self._send(np.array([OP_QUERY, b, k, -1 if t_margin is None else t_margin],
                            np.float32), batch)

    def shutdown(self) -> None:
        """Process 0: release every worker from its loop (under ``lock``)."""
        self._stop.set()
        self._send(np.array([OP_SHUTDOWN, 0, 0, -1], np.float32))

    def receive(self) -> Tuple[float, np.ndarray, int, Optional[int]]:
        """Worker: block until process 0's next dispatch or shutdown, past
        heartbeats; returns (opcode, batch[:b], k, t_margin)."""
        while True:
            header = torch.zeros(_HEADER_LEN, dtype=torch.float32)
            dist.broadcast(header, src=0)
            op = float(header[0])
            if op != OP_HEARTBEAT:
                break
        b, k, tm = int(header[1]), int(header[2]), int(header[3])
        batch = np.zeros(self.batch_shape, np.float32)
        if op == OP_QUERY:
            t = torch.from_numpy(batch)
            dist.broadcast(t, src=0)
        return op, batch[:b], k, (None if tm < 0 else tm)


def worker_loop(engine) -> int:
    """Processes > 0: replay process 0's dispatch stream until shutdown;
    returns the dispatches run.

    ``engine`` is a :class:`~image_search_engine_tpu_torch.engine.
    QueryEngine` built with ``prewarm=False`` on the same artifacts and
    flags as process 0's; its ``_fused_raw`` is the served dispatch without
    the broadcast (``serving/fused.BatchedSearch.run``), run on the
    engine's device thread and waited for, so a failed dispatch raises
    here and the loop never runs ahead of the device."""
    co = engine._mh_coordinator
    run = engine._fused_raw
    if co is None or run is None:
        raise RuntimeError(
            "worker_loop needs a multi-host fused serving path (is the engine built on a "
            "multi-process mesh with a fused family?)")
    rank = dist.get_rank()
    log.info("process %d: serving worker up (%d-row broadcast shape)", rank, co.max_batch)

    def run_and_wait(batch, k, tm):
        run(batch, k, tm)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    n = 0
    while True:
        op, batch, k, tm = co.receive()
        if op == OP_SHUTDOWN:
            log.info("process %d: shutdown after %d dispatches", rank, n)
            return n
        engine._on_device(run_and_wait, batch, k, tm)
        n += 1
