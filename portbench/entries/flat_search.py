"""Batch exact search: callers hand ``FlatIndex.search`` host queries and
take host answers back, in a closed loop.

The configuration's store (``corpus: "gaussian"``: i.i.d. standard normal
rows, drawn on the device from the seed, then the query batches from the
same generator, copied to the host once) is added to a ``FlatIndex`` of
its metric and store dtype. The window calls ``search(queries, k)`` on the mix's pool of query
batches in turn, ``callers`` = 1: each call uploads the queries, searches
at the index's margins (the certificate's retry included) and copies the
answers back. A sample of calls drawn from the seed keeps its answers,
which the reference judges after the window: exact squared l2 in float64
over the store's rows as stored (bf16-rounded for a bf16 store), ranked
with the query cast to the store dtype, the uncast query's norm added.
The control is the program's own int8 store over the same rows.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import data
from portbench.entries import TraceSpan, Window, now, sync
from portbench.reference import search as ref_search

STORE_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
ORACLE_ROWS = 1 << 15  # store rows per float64 product of the reference search


def _groupmin_launches() -> int:
    from image_search_engine_tpu_torch.serving.fused import launch_counters

    return sum(n for (fn, attr), n in launch_counters().items()
               if fn.__name__.startswith("groupmin") and attr == "launches")


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.index = None
        self.kept = {}  # call number -> (batch, distances, ids)
        self.failed = 0

    def _draw(self, queries: bool):
        """The (rows, dim) f32 rows on the device; with ``queries``, also
        the (batches, per call, dim) f32 host queries drawn after them."""
        cfg, mix = self.cfg, self.mix
        if cfg["corpus"] != "gaussian":
            raise ValueError(f"unknown corpus {cfg['corpus']!r}")
        g = data.generator(self.seed, data.ROWS, device=self.device)
        rows = torch.randn((cfg["rows"], cfg["dim"]), generator=g, device=self.device)
        if not queries:
            return rows
        q = torch.randn((mix["query_batches"], mix["queries_per_call"], cfg["dim"]),
                        generator=g, device=self.device)
        return rows, q.cpu().numpy()

    def _build(self, dtype: str):
        from image_search_engine_tpu_torch.index.flat import FlatIndex

        return FlatIndex(self.cfg["metric"], dtype=dtype, device=self.device).add(
            self._draw(False))

    def setup(self) -> None:
        from image_search_engine_tpu_torch.index.flat import FlatIndex

        rows, self.queries = self._draw(True)
        self.index = FlatIndex(self.cfg["metric"], dtype=self.cfg["store_dtype"],
                               device=self.device).add(rows)
        del rows
        for b in range(min(2, len(self.queries))):
            self.index.search(self.queries[b], self.mix["k"])
        sync(self.device)

    def window(self, seconds: float, tracer) -> Window:
        k, batches = self.mix["k"], len(self.queries)
        keep = self.mix["sample_calls"]
        rng = data.numpy_rng(self.seed, data.SAMPLE)
        calls = failed = 0
        g0 = _groupmin_launches()
        t0 = now()
        span = TraceSpan(tracer, seconds, self.mix["trace_seconds"], lambda: now() - t0)
        while True:
            b = calls % batches
            try:
                d, i = self.index.search(self.queries[b], k)
            except Exception:  # noqa: BLE001 - a failed call is counted, the loop goes on
                failed += 1
                d = i = None
            if d is not None:  # reservoir sample of the answered calls
                if len(self.kept) < keep:
                    self.kept[calls] = (b, d, i)
                else:
                    j = int(rng.integers(0, calls + 1))
                    if j < keep:
                        self.kept.pop(sorted(self.kept)[j])
                        self.kept[calls] = (b, d, i)
            calls += 1
            span.tick({"searches": calls, "queries": calls * self.queries.shape[1]})
            if now() - t0 >= seconds:
                break
        span.finish({"searches": calls, "queries": calls * self.queries.shape[1]})
        window_s = now() - t0
        self.failed = failed
        return Window(attempted=calls, failed=failed, window_s=window_s,
                      counts={"searches": calls, "queries": (calls - failed) * self.queries.shape[1],
                              "groupmin_launches": _groupmin_launches() - g0})

    def release(self) -> None:
        self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _judge(self, answers) -> dict:
        """The worst of each number over ``answers``: (batch, distances,
        ids) triples. The reference runs once a batch, scoring every
        answer's ids of that batch beside its best."""
        cfg, k = self.cfg, self.mix["k"]
        dtype = STORE_TORCH[cfg["store_dtype"]]
        x = self._draw(False).to(dtype).to(torch.float32)
        blocks = [(s, x[s:s + ORACLE_ROWS]) for s in range(0, x.shape[0], ORACLE_ROWS)]
        worst: dict = {}
        for b in sorted({a[0] for a in answers}):
            mine = [(d, i) for bb, d, i in answers if bb == b]
            q = torch.from_numpy(self.queries[b]).to(self.device)
            ids = torch.from_numpy(np.concatenate([i for _, i in mine], 1)).to(self.device)
            best, _, probe = ref_search.exact_knn(q.to(dtype).to(torch.float32),
                                                  (q.double() ** 2).sum(1), blocks, k, probe=ids)
            for j, (d, i) in enumerate(mine):
                got = ref_search.judge(torch.from_numpy(d), torch.from_numpy(i), best,
                                       probe[:, j * k:(j + 1) * k], cfg["rows"])
                for name, v in got.items():
                    worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def check(self) -> dict:
        """The sampled calls judged; ``missing``: the calls that failed (a
        window with no answered call misses one)."""
        numbers = self._judge(list(self.kept.values()))
        numbers["missing"] = float(self.failed or not self.kept)
        return numbers

    def control(self) -> dict:
        """The numbers with the program's int8 store in place of the
        configuration's: the same rows, the sampled batches searched once."""
        index = self._build("int8")
        answers = [(b, *index.search(self.queries[b], self.mix["k"]))
                   for b in sorted({a[0] for a in self.kept.values()})]
        del index
        self.release()
        return self._judge(answers)
