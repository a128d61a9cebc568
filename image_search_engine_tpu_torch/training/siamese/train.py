"""Siamese trainer: metric learning with best-val checkpointing and resume.

Port of ``image_search_engine_tpu/training/siamese/train.py``:

  * a train step: device-side augmentation (positive = augmented anchor),
    one shared-weight forward over the triple, the triplet or circle loss,
    SGD with momentum 0.937 at lr 1e-4 (``torch.optim.SGD``, dampening 0,
    no Nesterov: optax's ``g + momentum * trace``);
  * uint8 batches upload as they are and become [0, 1] f32 on the device
    (``ops/image_ops.to_unit_f32``); ``compute_dtype="bf16"`` runs the
    forward and backward under ``torch.autocast(bfloat16)`` while the
    parameters, the optimizer state and the loss stay f32; ``"f32"`` turns
    TF32 off on the card, as the embedder does;
  * the augmentation and the dropout draw from two ``torch.Generator``s on
    the trainer's device, both seeded from ``cfg.seed + 17``;
  * checkpointing gated on the best validation loss, files
    ``epoch_{e:02d}-loss_{v:.4f}.pt`` (``utils/checkpoint.save_tree_file``,
    on ``torch.save``; the JAX package's are flax msgpack), with
    latest-epoch resume (``maybe_resume`` sets ``start_epoch``);
  * ReduceLROnPlateau(factor 0.5, patience 7), written out on the
    optimizer's learning rate;
  * the loss meter keeps device sums and reads back once per epoch
    (``AverageMeter.avg``), so a step never waits for the card;
  * KeyboardInterrupt-safe;
  * data-parallel over a mesh (``Trainer(cfg, mesh=)``, ``--sharded
    [N]``): a step on the mesh is the unsharded step over the same global
    batch, draws and state. The batch is split into ``mesh.size`` slices,
    one a shard, each run on its shard's device; the BatchNorms' statistics
    and the loss span every shard, the augmentation and dropout draws are
    taken once for the global batch and sliced, and one summed gradient
    steps every replica alike (``parallel/data_parallel.py`` says how).
    Every process reads the same global batches; only process 0 writes the
    checkpoints and the metrics.

    python -m image_search_engine_tpu_torch.training.siamese.train \\
        --train-dir cards/train --valid-dir cards/valid [--device cuda|cpu] [--sharded [N]]
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import time
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from image_search_engine_tpu_torch.models.layers import at_least_f32, shard_batch_norm
from image_search_engine_tpu_torch.models.weights import load_torch_weights
from image_search_engine_tpu_torch.ops.image_ops import to_unit_f32
from image_search_engine_tpu_torch.parallel.data_parallel import (
    ShardThreads, gather_batch, reduce_gradients, run_shards)
from image_search_engine_tpu_torch.parallel.mesh import Mesh, make_mesh
from image_search_engine_tpu_torch.training.siamese.augmentations import apply, sample_params
from image_search_engine_tpu_torch.training.siamese.config import (
    SiameseConfig,
    ckpt_filename,
    get_best_val_loss,
    get_latest_checkpoint,
)
from image_search_engine_tpu_torch.training.siamese.dataset import PairsGenerator
from image_search_engine_tpu_torch.training.siamese.losses import (
    circle_loss,
    self_supervised_circle_loss,
    triplet_loss,
)
from image_search_engine_tpu_torch.training.siamese.model import EmbeddingNet, apply_siamese
from image_search_engine_tpu_torch.utils.checkpoint import load_tree_file, save_tree_file
from image_search_engine_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


class AverageMeter:
    """Running mean. ``update`` accepts device scalars without reading them
    back (the sum stays on the device); ``avg`` is the one synchronizing
    readback."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1) -> None:
        if torch.is_tensor(value):
            value = value.detach()
        self.sum = self.sum + value * n
        self.count += n

    @property
    def avg(self) -> float:
        return float(self.sum) / max(self.count, 1)


_PREFETCH_DONE = object()


class Prefetcher:
    """Background-thread batch prefetch: the host decodes batch i+1 while
    the device runs step i (one daemon thread and a bounded queue).
    ``stop()`` is interrupt-safe — the thread parks on bounded puts and
    re-checks the stop flag, so Ctrl-C never hangs."""

    def __init__(self, iterator, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def put_checked(item) -> None:
            # every producer put is bounded + stop-flag-rechecked — the
            # end-of-iterator sentinel and error puts included, so stop()
            # after the queue fills never strands the thread
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    return
                except queue.Full:
                    continue

        def run():
            try:
                for item in iterator:
                    put_checked(item)
                    if self._stop.is_set():
                        return
                put_checked(_PREFETCH_DONE)
            except BaseException as e:  # surface decode errors to consumer
                put_checked(e)

        self._thread = threading.Thread(target=run, daemon=True, name="batch-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        import queue

        # bounded get + stop-flag recheck: once stop() is set the producer
        # drops its sentinel/error puts, so an unbounded q.get() here could
        # block forever if another thread races stop() against this one
        while True:
            try:
                item = self._q.get(timeout=0.25)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if item is _PREFETCH_DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def stop(self) -> None:
        self._stop.set()


def make_loss_fn(cfg: SiameseConfig):
    if cfg.loss == "triplet":
        return lambda a, p, n: torch.mean(triplet_loss(a, p, n, cfg.triplet_margin))
    if cfg.loss == "circle":
        return lambda a, p, n: circle_loss(a, p, n, cfg.circle_margin, cfg.circle_scale)
    if cfg.loss == "self_supervised_circle":
        return lambda a, p, n: self_supervised_circle_loss(
            a, p, cfg.circle_margin, cfg.circle_scale)
    raise ValueError(f"unknown loss {cfg.loss!r}")


def _seeds(seed: int, n: int) -> list:
    """n independent 63-bit seeds derived from ``seed``."""
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(seed).spawn(n)]


def _slice_params(params: dict, lo: int, hi: int, device: torch.device) -> dict:
    """Images ``lo:hi`` of ``sample_params``' draws, on ``device``."""
    return {k: (_slice_params(v, lo, hi, device) if isinstance(v, dict) else
                v[lo:hi].to(device)) for k, v in params.items()}


class Trainer:
    """The siamese net, its optimizer and generators on ``device`` (the
    card unless the CPU is asked for). ``dropout_rate`` is the head's
    (the JAX ``EmbeddingNet`` attribute's default, 0.3). With a ``mesh``
    the home device is the mesh's, and each distinct local device of the
    mesh holds a replica of the net with its own optimizer."""

    def __init__(self, cfg: SiameseConfig, device: str | torch.device = "cuda",
                 dropout_rate: float = 0.3, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            for dev in mesh.devices:  # a mesh on the card needs the card
                resolve_device(dev)
            device = mesh.home
        self.device = resolve_device(device)
        model = EmbeddingNet(embedding_dim=cfg.embedding_dim, dropout_rate=dropout_rate,
                             freeze_backbone=cfg.freeze_backbone, backbone=cfg.backbone,
                             generator=torch.Generator().manual_seed(cfg.seed))
        if cfg.torch_weights is not None:
            # a pretrained torchvision backbone under the head
            load_torch_weights(model.backbone, cfg.torch_weights)
        if cfg.compute_dtype == "f32" and self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device)
        devices = list(dict.fromkeys(mesh.devices)) if mesh is not None else [self.device]
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d) for d in devices[1:]]
        self._replica_of = ([devices.index(d) for d in mesh.devices] if mesh is not None
                            else [0])
        self.opts = [torch.optim.SGD(r.parameters(), lr=cfg.lr, momentum=cfg.momentum,
                                     dampening=0.0, nesterov=False) for r in self.replicas]
        self.opt = self.opts[0]
        self._threads = None
        if mesh is not None and mesh.local_size > 1:
            self._threads = ShardThreads(mesh.local_size)
            # stopped when the trainer goes; not at exit, where a thread that
            # ends after the CUDA runtime has gone aborts the process
            weakref.finalize(self, self._threads.close).atexit = False
        aug_seed, drop_seed = _seeds(cfg.seed + 17, 2)
        self.aug_gen = torch.Generator(self.device).manual_seed(aug_seed)
        self.drop_gen = torch.Generator(self.device).manual_seed(drop_seed)
        self.start_epoch = 0
        self.best_val = get_best_val_loss(cfg.ckpt_dir)
        self._loss_fn = make_loss_fn(cfg)

    # -- steps ------------------------------------------------------------------
    def _autocast(self):
        if self.cfg.compute_dtype == "bf16":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _upload(self, images, device: Optional[torch.device] = None) -> torch.Tensor:
        """Host (or device) images -> [0, 1] f32 on the device, uint8
        uploaded as it is and cast there."""
        return to_unit_f32(torch.as_tensor(images).to(device or self.device))

    def _loss(self, anchors, negatives, aug_params, train: bool) -> torch.Tensor:
        if self.mesh is not None:
            return self._sharded_loss(anchors, negatives, aug_params, train)
        a, n = self._upload(anchors), self._upload(negatives)
        if aug_params is None:
            aug_params = sample_params(self.aug_gen, *a.shape[:3])
        p = apply(a, aug_params)
        with self._autocast():
            ea, ep, en = apply_siamese(self.model, (a, p, n), self.drop_gen if train else None)
        return self._loss_fn(at_least_f32(ea), at_least_f32(ep), at_least_f32(en))

    def _check_divides(self, batch: int) -> None:
        if self.mesh is not None and batch % self.mesh.size:
            raise ValueError(f"batch {batch} does not divide into {self.mesh.size} shards")

    def _sharded_loss(self, anchors, negatives, aug_params, train: bool) -> torch.Tensor:
        """The global batch's loss, each shard's slice on its own device.
        The draws are the unsharded step's: the augmentation's over the
        global batch, and the dropout masks over its 3B concatenated rows
        (a_s, p_s and n_s are rows s·b, B + s·b and 2B + s·b)."""
        mesh, home = self.mesh, self.device
        batch = int(anchors.shape[0])
        self._check_divides(batch)
        b = batch // mesh.size
        if aug_params is None:
            aug_params = sample_params(self.aug_gen, batch, *anchors.shape[1:3])
        masks = self.model.draw_masks(3 * batch, self.drop_gen, home) if train else None

        def shard(s: int, sync=None):
            dev, model = mesh.devices[s], self.replicas[self._replica_of[s]]
            lo = (mesh.first_shard + s) * b
            a = self._upload(anchors[lo:lo + b], dev)
            n = self._upload(negatives[lo:lo + b], dev)
            p = apply(a, _slice_params(aug_params, lo, lo + b, dev))
            rows = torch.cat([torch.arange(lo, lo + b, device=home) + j * batch
                              for j in range(3)])
            m = None if masks is None else [mk[rows].to(dev) for mk in masks]
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                if sync is not None:
                    stack.enter_context(torch.enable_grad())
                    stack.enter_context(shard_batch_norm(sync))
                stack.enter_context(self._autocast())
                return torch.stack(model(torch.cat([a, p, n]), masks=m).chunk(3))

        if train:
            outs = run_shards(shard, mesh, self._threads)
        else:  # running statistics: the shards do not meet
            outs = [shard(s) for s in range(mesh.local_size)]
        emb = gather_batch(torch.cat([o.to(home) for o in outs], dim=1), mesh, dim=1)
        return self._loss_fn(*(at_least_f32(e) for e in emb))

    def _train_mode(self, mode: bool) -> None:
        for r in self.replicas:
            r.train(mode)

    def train_step(self, anchors, negatives, aug_params: Optional[dict] = None) -> torch.Tensor:
        """One SGD step on an (anchor, negative) batch; returns the loss as
        a device scalar. ``aug_params`` overrides the augmentation's draws
        (``augmentations.sample_params``' layout)."""
        self._train_mode(True)
        loss = self._loss(anchors, negatives, aug_params, True)
        for opt in self.opts:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            reduce_gradients(self.replicas, self.mesh)
        for opt in self.opts:
            opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, anchors, negatives, aug_params: Optional[dict] = None) -> torch.Tensor:
        self._train_mode(False)
        return self._loss(anchors, negatives, aug_params, False)

    # -- checkpointing ------------------------------------------------------------
    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints and metrics (process 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.world > 1:
            torch.distributed.barrier()

    def save_checkpoint(self, epoch: int, val_loss: float) -> Path:
        """Process 0 writes; on a mesh over processes every process returns
        once the file is there."""
        path = self.cfg.ckpt_dir / ckpt_filename(epoch, val_loss)
        if self.writes:
            self.cfg.ckpt_dir.mkdir(parents=True, exist_ok=True)
            save_tree_file(path, {"model": self.model.state_dict(),
                                  "optimizer": self.opt.state_dict(),
                                  "epoch": epoch, "val_loss": val_loss})
        self._barrier()
        return path

    def load_checkpoint(self, path: str | Path) -> int:
        state = load_tree_file(path)  # on the CPU; the loads below copy to the device
        for model, opt in zip(self.replicas, self.opts):
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optimizer"])
        self.start_epoch = int(state["epoch"]) + 1
        return self.start_epoch

    def maybe_resume(self) -> None:
        """Resume from the latest epoch checkpoint if one exists."""
        latest = get_latest_checkpoint(self.cfg.ckpt_dir)
        if latest is not None:
            epoch = self.load_checkpoint(latest)
            log.info("resumed from %s (next epoch %d, best val %.4f)",
                     latest.name, epoch, self.best_val)

    # -- LR plateau schedule ------------------------------------------------------
    def _set_lr(self, lr: float) -> None:
        for opt in self.opts:
            for group in opt.param_groups:
                group["lr"] = lr

    def _get_lr(self) -> float:
        return float(self.opt.param_groups[0]["lr"])

    # -- main loop ----------------------------------------------------------------
    def run(
        self,
        train_gen: Optional[PairsGenerator] = None,
        valid_gen: Optional[PairsGenerator] = None,
        epochs: Optional[int] = None,
        steps_per_epoch: Optional[int] = None,
        val_steps: int = 4,
    ) -> Dict[str, Any]:
        cfg = self.cfg
        train_gen = train_gen or PairsGenerator.from_dir(
            cfg.train_dir, cfg.batch_size, cfg.image_size, cfg.seed)
        valid_gen = valid_gen or PairsGenerator.from_dir(
            cfg.valid_dir, cfg.batch_size, cfg.image_size, cfg.seed + 1)
        epochs = epochs or cfg.epochs
        steps_per_epoch = steps_per_epoch or train_gen.steps_per_epoch()
        self._check_divides(train_gen.batch_size)
        self._check_divides(valid_gen.batch_size)
        self.maybe_resume()

        # host decode of batch i+1 overlaps device step i
        train_iter = Prefetcher(iter(train_gen))
        valid_iter = Prefetcher(iter(valid_gen))
        plateau = 0
        history = []
        if self.writes:
            cfg.log_file.parent.mkdir(parents=True, exist_ok=True)

        try:
            for epoch in range(self.start_epoch, epochs):
                t0 = time.time()
                meter = AverageMeter()
                for _ in range(steps_per_epoch):
                    anchors, negatives = next(train_iter)
                    meter.update(self.train_step(anchors, negatives))

                vmeter = AverageMeter()
                for _ in range(val_steps):
                    anchors, negatives = next(valid_iter)
                    vmeter.update(self.eval_step(anchors, negatives))

                rec = {
                    "epoch": epoch, "loss": meter.avg, "val_loss": vmeter.avg,
                    "lr": self._get_lr(), "seconds": round(time.time() - t0, 2),
                }
                history.append(rec)
                if self.writes:
                    with open(cfg.log_file, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                log.info("epoch %d: loss %.4f val %.4f lr %.2e (%.1fs)",
                         epoch, meter.avg, vmeter.avg, rec["lr"], rec["seconds"])

                if vmeter.avg < self.best_val:
                    self.best_val = vmeter.avg
                    path = self.save_checkpoint(epoch, vmeter.avg)
                    log.info("saved best checkpoint %s", path.name)
                    plateau = 0
                else:
                    plateau += 1
                    if plateau >= cfg.lr_reduce_patience:
                        self._set_lr(self._get_lr() * cfg.lr_reduce_factor)
                        log.info("plateau: lr -> %.2e", self._get_lr())
                        plateau = 0
        except KeyboardInterrupt:  # graceful stop at an epoch boundary
            log.info("interrupted at epoch boundary; latest best val %.4f", self.best_val)
        finally:
            train_iter.stop()
            valid_iter.stop()

        return {"best_val": self.best_val, "history": history}

    # -- inference helper (the one-head net) ----------------------------------------
    @torch.no_grad()
    def embed(self, images: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """(N, H, W, 3) uint8 or [0, 1] float host images -> (N, D) host f32
        embeddings, in chunks of ``batch_size``, on the home device."""
        images = np.asarray(images)
        self.model.eval()
        out = []
        for s in range(0, images.shape[0], batch_size):
            with self._autocast():
                out.append(self.model(self._upload(images[s:s + batch_size])).float().cpu().numpy())
        return np.concatenate(out)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-dir", type=Path, required=True)
    ap.add_argument("--valid-dir", type=Path, required=True)
    ap.add_argument("--ckpt-dir", type=Path, default=Path("artifacts/siamese_ckpts"))
    ap.add_argument("--loss", default="circle",
                    choices=["triplet", "circle", "self_supervised_circle"])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--backbone", default="densenet121")
    ap.add_argument("--image-size", type=int, nargs=2, default=(352, 256),
                    metavar=("H", "W"))
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--torch-weights", type=Path, default=None,
                    help="torchvision densenet .pth to load as the backbone init")
    ap.add_argument("--unfreeze-backbone", action="store_true",
                    help="train the backbone too (default: head only, like "
                    "the reference's FREEZE_BACKBONE)")
    ap.add_argument("--compute-dtype", default="bf16", choices=["bf16", "f32"],
                    help="forward/backward compute precision (params, "
                         "optimizer state and loss stay f32 either way)")
    ap.add_argument("--sharded", type=int, nargs="?", const=0, default=None, metavar="N",
                    help="data-parallel over a 1-D mesh of the first N local devices (no N = "
                         "all; on the CPU, N shards of it); batch must divide it")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card) or cpu")
    a = ap.parse_args(argv)
    cfg = SiameseConfig(
        train_dir=a.train_dir, valid_dir=a.valid_dir, ckpt_dir=a.ckpt_dir, loss=a.loss,
        epochs=a.epochs, batch_size=a.batch_size, backbone=a.backbone,
        image_size=tuple(a.image_size), embedding_dim=a.embedding_dim, lr=a.lr,
        freeze_backbone=not a.unfreeze_backbone, torch_weights=a.torch_weights,
        compute_dtype=a.compute_dtype,
    )
    return cfg, a


def main(argv=None) -> Dict[str, Any]:
    cfg, a = parse_args(argv)
    mesh = None
    if a.sharded is not None:
        mesh = make_mesh(a.sharded or None, a.device)
        log.info("data-parallel training over a %d-shard mesh", mesh.size)
    return Trainer(cfg, device=a.device, mesh=mesh).run()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
