"""Served image queries: users send one decoded image each, on an open-loop
schedule, to the port's served ``search(image, k)``.

The served entry is what the query engine composes for a CNN over a flat
index: ``serving/fused.wrap_serving`` over ``make_batched_search(
cnn_prologue(embedder), *flat_family(index))``, each dispatch a CUDA graph
replay on the device thread, with the micro-batcher in front when the mix
turns it on. The harness composes it in memory over the index it builds
(an index file of the corpus would be gigabytes), and leaves out the HTTP
layer, whose multipart parse and image decode the host paces.

Inputs, all from the seed: the backbone's weights (bf16, as served), a
pool of query images, and the corpus, ``rows`` near duplicates of the
pool's embeddings as the reference backbone computes them at set-up
(``data.near_dup_blocks``). After the window a sample of the answered
requests, drawn from the seed, is judged: the reference backbone (f32,
TF32 off) embeds each sampled image and an exact float64 search over the
corpus, made again from the seed, gives the best answers. The control puts
the reference backbone in float8 e4m3 in the program's place.
"""

from __future__ import annotations

import gc
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from portbench import data, schedule
from portbench.entries import Window, now, sync
from portbench.reference import resnet50 as R
from portbench.reference import search as ref_search

REF_BLOCK = 64  # images per reference forward pass


class Escalations:
    """The flat family's counter of certificate retries (``stats``)."""

    def __init__(self):
        self.queries = 0
        self.retries = 0

    def record_escalation(self, n: int) -> None:
        self.queries += n
        self.retries += 1


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.answers = {}  # request number -> (pool item, distances, ids)
        self.failed = 0
        self.escalations = Escalations()

    # -- inputs ---------------------------------------------------------------
    def _corpus(self):
        c = self.cfg["corpus"]
        if c["kind"] != "near_dup":
            raise ValueError(f"unknown corpus {c['kind']!r}")
        return c

    def _blocks(self):
        c = self._corpus()
        return data.near_dup_blocks(self.anchors, self.cfg["rows"], self.seed, tuple(c["spread"]))

    def setup(self) -> None:
        from image_search_engine_tpu_torch.config import Config
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.models.embedder import CNNEmbedder
        from image_search_engine_tpu_torch.serving import fused

        cfg, mix, dev = self.cfg, self.mix, self.device
        bb = cfg["backbone"]
        size = bb["image_size"]
        self.weights = data.resnet50_weights(self.seed, dev, getattr(torch, bb["dtype"]))
        pool = data.images(self.seed, self._corpus()["anchors"], size, dev)
        self.ref = R.ResNet50(self.weights, dev)
        self.anchors = self.ref.embed_blocks(pool, REF_BLOCK)
        self.pool = pool.cpu().numpy().astype(np.float32) / np.float32(255.0)
        del pool
        rows = data.near_dup_rows(self.anchors, cfg["rows"], self.seed,
                                  tuple(self._corpus()["spread"]))
        self.index = FlatIndex(cfg["metric"], dtype=cfg["store_dtype"], device=dev).add(rows)
        del rows
        self.embedder = CNNEmbedder(bb["arch"], image_size=size, batch_size=1,
                                    dtype=getattr(torch, bb["dtype"]), device=dev,
                                    state_dict=self.weights)
        self.batched = fused.make_batched_search(
            fused.cnn_prologue(self.embedder, normalize=cfg["metric"] == "cosine"),
            *fused.flat_family(self.index, stats=self.escalations), device=dev)
        self.engine = types.SimpleNamespace()
        serving = Config(micro_batch=mix["micro_batch"])
        self.search = fused.wrap_serving(self.engine, self.batched, size, serving)
        # what the engine's prewarm captures: B = 1, then B = micro_batch_max
        k = mix["k"]
        self.search(np.zeros((size, size, 3), np.float32), k)
        if getattr(self.engine, "_extra_prewarm", None) is not None:
            self.engine._extra_prewarm(k)
        for j in range(4):
            self.search(self.pool[j % len(self.pool)], k)
        self.clients = ThreadPoolExecutor(max_workers=mix["clients"],
                                          thread_name_prefix="client")
        wait([self.clients.submit(time.sleep, 0.01) for _ in range(mix["clients"])])
        sync(dev)

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float, tracer) -> Window:
        mix, k = self.mix, self.mix["k"]
        sched = schedule.open_loop(mix, seconds, len(self.pool), self.seed)
        n = len(sched.due_s)
        keep = set(schedule.sample(n, mix["sample_requests"], self.seed).tolist())
        lat = np.full(n, np.inf)
        late = np.zeros(n)
        lock = threading.Lock()
        done = [0]

        def request(j: int, due: float) -> None:
            item = int(sched.item[j])
            try:
                d, i = self.search(self.pool[item], k)
            except Exception:  # noqa: BLE001 - a failed request misses, the window goes on
                return
            lat[j] = now() - due
            with lock:
                done[0] += 1
            if j in keep:
                self.answers[j] = (item, d, i)

        def counts():
            return {"replays": self.batched.replays, "requests": done[0]}

        futures = []
        r0 = self.batched.replays
        t0 = now() + 0.005
        length = min(mix["trace_seconds"], seconds / 2)
        trace_at, settle_s = (seconds - length) / 2, 0.25
        mark_at = end_at = None

        def quiesce_then(action) -> None:
            """``action()`` with nothing in flight; the schedule resumes
            where it paused (the profiler must not start or stop under
            concurrent launches)."""
            nonlocal t0
            p = now()
            wait(futures)
            action()
            t0 += now() - p

        for j in range(n):
            due = t0 + sched.due_s[j]
            dt = due - now()
            if dt > 0:
                time.sleep(dt)
            late[j] = now() - due
            futures.append(self.clients.submit(request, j, due))
            if not tracer.enabled or tracer.ended:
                continue
            el = now() - t0
            if not tracer.started and el >= trace_at:
                quiesce_then(tracer.start)
                mark_at = now() - t0 + settle_s
            elif mark_at is not None and not tracer.marked and el >= mark_at:
                tracer.mark_start(counts())
                end_at = el + length
            elif tracer.marked and el >= end_at:
                tracer.mark_end(counts())
                quiesce_then(tracer.stop)
        wait(futures, timeout=max(0.0, t0 + seconds + 60.0 - now()))
        if tracer.started and not tracer.ended:  # a window too short to reach the end
            if tracer.marked:
                tracer.mark_end(counts())
            tracer.stop()
        window_s = now() - t0
        self.failed = int(np.isinf(lat).sum())
        done_lat = np.sort(lat[np.isfinite(lat)]) * 1e3
        notes = [f"requests {n}, answered {n - self.failed}, p50 "
                 f"{np.percentile(done_lat, 50) if len(done_lat) else float('nan'):.4f} ms; "
                 f"generator late p50 {np.percentile(late, 50) * 1e3:.4f} ms, max "
                 f"{late.max() * 1e3 if n else 0.0:.4f} ms; certificate retries "
                 f"{self.escalations.retries}"]
        return Window(attempted=n, failed=self.failed, window_s=window_s,
                      counts={"requests": n - self.failed, "replays": self.batched.replays - r0,
                              "retries": self.escalations.retries},
                      latencies_s=lat, notes=notes)

    def release(self) -> None:
        batcher = getattr(self.engine, "_batcher", None)
        if batcher is not None:
            batcher.close()
        self.engine._device_thread.shutdown(wait=True)
        self.clients.shutdown(wait=True)
        self.search = self.batched = self.engine = self.embedder = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------------
    def _judge(self, answers, embed) -> dict:
        """The worst of each number over ``answers`` ((item, distances,
        ids)), against the reference's exact search for the items'
        embeddings by ``embed``."""
        items = sorted({a[0] for a in answers})
        pos = {it: j for j, it in enumerate(items)}
        e = embed(torch.from_numpy(self.pool[items]))
        k = self.mix["k"]
        cols = []  # (answer, its row in e, first column of its ids in the probe)
        per_item = {it: [] for it in items}
        for a in answers:
            per_item[a[0]].append(a)
        width = max(len(v) for v in per_item.values()) * k
        probe = torch.full((len(items), width), -1, dtype=torch.long)
        for it, lst in per_item.items():
            for m, (_, d, i) in enumerate(lst):
                probe[pos[it], m * k:(m + 1) * k] = torch.from_numpy(i.astype(np.int64))
                cols.append((d, i, pos[it], m * k))
        best, _, probe_d = ref_search.exact_knn(e, (e.double() ** 2).sum(1), self._blocks(), k,
                                                probe=probe.to(self.device))
        worst: dict = {}
        for d, i, row, c in cols:
            got = ref_search.judge(torch.from_numpy(d), torch.from_numpy(i), best[row:row + 1],
                                   probe_d[row:row + 1, c:c + k], self.cfg["rows"])
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def check(self) -> dict:
        numbers = self._judge(list(self.answers.values()),
                              lambda imgs: self.ref.embed_blocks(imgs, REF_BLOCK))
        numbers["missing"] = float(self.failed or not self.answers)
        return numbers

    def control(self) -> dict:
        """The numbers with the reference backbone in float8 e4m3 in the
        program's place: its exact answers for the sampled items."""
        fp8 = R.ResNet50(self.weights, self.device, fp8=True)
        items = sorted({a[0] for a in self.answers.values()})
        e8 = fp8.embed_blocks(torch.from_numpy(self.pool[items]), REF_BLOCK)
        k = self.mix["k"]
        d8, i8, _ = ref_search.exact_knn(e8, (e8.double() ** 2).sum(1), self._blocks(), k)
        answers = [(it, d8[j:j + 1].cpu().numpy(), i8[j:j + 1].cpu().numpy())
                   for j, it in enumerate(items)]
        return self._judge(answers, lambda imgs: self.ref.embed_blocks(imgs, REF_BLOCK))
