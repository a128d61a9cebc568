"""Indexing: a corpus builder grows the configuration's index by embedding
host image batches with ``CNNEmbedder.embed_batch`` (the indexer's call)
and adding the embeddings to the ``FlatIndex`` in one ``add`` at the end,
in a closed loop.

Set-up builds the configuration's store on the device, ``rows`` near
duplicates of the query pool's embeddings as the reference backbone
computes them (the served cells' corpus, ``data.near_dup_blocks``), in a
``FlatIndex`` of its metric and dtype. The window embeds the mix's pool of
seeded uint8 batches in turn (file decode left out) until its time is up,
then adds everything it embedded to that index, which rebuilds the store
with the old rows and the new; both are inside the window. After it, a
sample of the new rows, drawn from the seed, is judged against the
reference backbone (f32, TF32 off) on the images they came from: the
widest relative distance of a row from the reference's embedding; and a
sample of the old rows is read back against the rows made again from the
seed, bit for bit. The control puts the reference in float8 e4m3 in the
program's place.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import data, schedule
from portbench.entries import TraceSpan, Window, now, sync
from portbench.reference import resnet50 as R

REF_BLOCK = 64  # images per reference forward pass


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.failed = 0

    def _corpus(self):
        c = self.cfg["corpus"]
        if c["kind"] != "near_dup":
            raise ValueError(f"unknown corpus {c['kind']!r}")
        return c

    def setup(self) -> None:
        from image_search_engine_tpu_torch.index.flat import FlatIndex
        from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

        cfg, mix, dev = self.cfg, self.mix, self.device
        bb, corpus = cfg["backbone"], self._corpus()
        self.batch = mix["batch_images"]
        self.weights = data.resnet50_weights(self.seed, dev, getattr(torch, bb["dtype"]))
        queries = data.images(self.seed, corpus["anchors"], bb["image_size"], dev)
        self.anchors = R.ResNet50(self.weights, dev).embed_blocks(queries, REF_BLOCK)
        del queries
        rows = data.near_dup_rows(self.anchors, cfg["rows"], self.seed, tuple(corpus["spread"]))
        self.index = FlatIndex(cfg["metric"], dtype=cfg["store_dtype"], device=dev).add(rows)
        del rows
        self.pool = data.images(self.seed, mix["pool_batches"] * self.batch, bb["image_size"],
                                dev, stream=1).cpu().numpy()
        self.embedder = CNNEmbedder(bb["arch"], image_size=bb["image_size"],
                                    batch_size=self.batch, dtype=getattr(torch, bb["dtype"]),
                                    device=dev, state_dict=self.weights)
        for _ in range(2):
            warm = self.embedder.embed_batch(self.pool[:self.batch])
        FlatIndex(cfg["metric"], dtype=cfg["store_dtype"], device=dev).add(warm)
        sync(dev)

    def window(self, seconds: float, tracer) -> Window:
        nb = len(self.pool) // self.batch
        embs, batches, failed = [], 0, 0
        t0 = now()
        span = TraceSpan(tracer, seconds, self.mix["trace_seconds"], lambda: now() - t0)
        while True:
            s = (batches % nb) * self.batch
            try:
                embs.append(self.embedder.embed_batch(self.pool[s:s + self.batch]))
            except Exception:  # noqa: BLE001 - a failed batch is counted, the loop goes on
                failed += 1
                embs.append(None)
            batches += 1
            span.tick({"batches": batches, "images": batches * self.batch})
            if now() - t0 >= seconds:
                break
        span.finish({"batches": batches, "images": batches * self.batch})
        # the rows of failed batches stay out: the index then misses them
        self.source = np.concatenate([np.arange(b % nb * self.batch, (b % nb + 1) * self.batch)
                                      for b, e in enumerate(embs) if e is not None])
        self.index.add(np.concatenate([e for e in embs if e is not None]))
        sync(self.device)
        window_s = now() - t0
        self.failed, self.images = failed, batches * self.batch
        base, self.ntotal = self.cfg["rows"], self.index.ntotal
        values = self.index.store.values()
        new = schedule.sample(max(0, self.ntotal - base), self.mix["sample_rows"], self.seed)
        self.kept = (self.source[new], values[torch.from_numpy(new + base).to(self.device)].cpu())
        self.old = schedule.sample(min(base, self.ntotal), self.mix["sample_rows"], self.seed + 1)
        self.old_rows = values[torch.from_numpy(self.old).to(self.device)].cpu()
        return Window(attempted=batches, failed=failed, window_s=window_s,
                      counts={"batches": batches - failed, "images": (batches - failed) * self.batch})

    def release(self) -> None:
        self.embedder = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _judge(self, items: np.ndarray, rows: torch.Tensor) -> dict:
        if len(items) == 0:  # no new row to judge: the add lost them
            return {"emb_err": float("inf")}
        ref = R.ResNet50(self.weights, self.device).embed_blocks(
            torch.from_numpy(self.pool[items]), REF_BLOCK).cpu().double()
        err = (rows.double() - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
        return {"emb_err": float(err.max())}

    def _old_rows_err(self) -> float:
        """The widest gap between a sampled old row as the index holds it
        after the add and that row made again from the seed."""
        want = torch.from_numpy(self.old).to(self.device)
        worst = 0.0
        for start, block in data.near_dup_blocks(self.anchors, self.cfg["rows"], self.seed,
                                                 tuple(self._corpus()["spread"])):
            sel = (want >= start) & (want < start + block.shape[0])
            if sel.any():
                got = self.old_rows.to(self.device)[sel]
                gap = (got - block[want[sel] - start]).abs().max()
                worst = max(worst, float(gap))
        return worst

    def check(self) -> dict:
        """``emb_err``: the widest relative distance of a sampled new row
        from the reference's embedding of its image; ``old_rows_err``: the
        widest gap of a sampled old row from the row as made; ``missing``:
        images embedded but not added, old rows lost, and failed
        batches."""
        numbers = self._judge(*self.kept)
        numbers["old_rows_err"] = self._old_rows_err()
        numbers["missing"] = float(abs(self.images - (self.ntotal - self.cfg["rows"]))
                                   + self.failed)
        return numbers

    def control(self) -> dict:
        items = self.kept[0]
        fp8 = R.ResNet50(self.weights, self.device, fp8=True).embed_blocks(
            torch.from_numpy(self.pool[items]), REF_BLOCK).cpu()
        return self._judge(items, fp8)
