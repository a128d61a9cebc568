"""Device meshes: one axis of shards, each on a torch device.

Port of ``image_search_engine_tpu/parallel/mesh.py``. Every layout is 1-D:
the corpus rows are the only axis worth sharding for an index-and-query
engine. A :class:`Mesh` is an explicit, ordered list of devices, one per
shard, and may repeat a device: ``Mesh([torch.device("cpu")] * 8)`` is the
counterpart of the 8 virtual CPU devices the JAX package's tests use, and
``Mesh([cuda:0] * 4)`` puts four shards on one card.

A mesh made after :func:`init_multihost` spans every process of the job.
Global shard order is process-major: process ``rank`` holds shards ``rank *
L .. rank * L + L - 1`` (L shards a process, the same in every process),
so a global row id is ``shard * rows_per_shard + local row`` as on one
process. The cross-process half of a search (parallel/topk.py) gathers each
process's merged candidates over the mesh's data group:

  * NCCL when every process has its own CUDA device (their UUIDs compared
    over the gloo group before any data moves);
  * otherwise gloo, with the small (Q, k) candidate, count and sum tensors
    staged through host memory (two processes on one card, or the CPU).

The rule is decided from the layout and logged once per mesh. A failed
collective raises; nothing switches from NCCL to gloo, or to an unsharded
search. The control plane (serving/multihost.py's broadcasts) is the
default gloo group, whose timeout bounds every wait for a peer.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from image_search_engine_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

#: seconds a collective waits for a peer before it raises
TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's shards' devices in global shard order.

    ``world`` processes of ``len(devices)`` shards each; ``group`` is the
    process group of the cross-process merge (None: one process, no
    collective) and ``staged`` says whether its tensors pass through host
    memory (gloo) or stay on the card (NCCL)."""

    devices: Sequence[torch.device]
    axis: str = "data"
    rank: int = 0
    world: int = 1
    group: Optional[object] = None
    staged: bool = False

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.local_size * self.world

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local_size

    @property
    def home(self) -> torch.device:
        """The device this process merges its shards' candidates on."""
        return self.devices[0]

    @property
    def one_device(self) -> bool:
        """All of this process's shards on one device (a dispatch over them
        runs on one stream and can be captured as one CUDA graph)."""
        return len(set(self.devices)) == 1


def _visible_devices(n_devices: Optional[int], device) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devs[:n_devices] if n_devices else devs
    # the CPU is one device, which a mesh repeats once per shard
    return [dev] * (n_devices or 1)


def _uuid(dev: torch.device) -> Optional[str]:
    return str(torch.cuda.get_device_properties(dev).uuid) if dev.type == "cuda" else None


def make_mesh(n_devices: Optional[int] = None, device="cuda", axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` visible devices of ``device``'s
    type (default: all; the CPU counts as ``n_devices`` shards of the one
    CPU). After :func:`init_multihost` the mesh spans every process, each
    contributing its own first ``n_devices`` devices."""
    devs = _visible_devices(n_devices, device)
    if not dist.is_initialized():
        return Mesh(devs, axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    layout: list = [None] * world
    dist.all_gather_object(layout, (len(devs), _uuid(devs[0])))
    if len({n for n, _ in layout}) != 1:
        raise ValueError(f"every process must hold the same number of shards, got "
                         f"{[n for n, _ in layout]}")
    uuids = [u for _, u in layout]
    if None not in uuids and len(set(uuids)) == world:
        torch.cuda.set_device(devs[0])
        group = dist.new_group(backend="nccl", timeout=datetime.timedelta(seconds=TIMEOUT_S))
        staged = False
        log.info("mesh over %d processes x %d shards: NCCL data plane (every process has "
                 "its own CUDA device)", world, len(devs))
    else:
        group, staged = dist.group.WORLD, True
        log.info("mesh over %d processes x %d shards: gloo data plane through host memory "
                 "(%s)", world, len(devs),
                 "the CPU" if None in uuids else "processes share a CUDA device")
    return Mesh(devs, axis, rank, world, group, staged)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None,
                   *, device="cuda") -> int:
    """Join a multi-process job: a gloo process group over
    ``tcp://coordinator_address`` with the given world size and rank, or
    over ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, as torchrun sets them) when no address is given. Every
    collective of the group raises after ``TIMEOUT_S`` without its peers.
    Call once per process before making a mesh. Returns the global device
    count."""
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(_visible_devices(None, device)))
    return sum(counts)


def mesh_from_config(cfg, device="cuda") -> Optional[Mesh]:
    """The serving or indexing mesh a CLI run asked for, or None.

    ``cfg.shard_devices`` (``--sharded``): 0 = all local devices, N = the
    first N. The ``cfg.dcn_*`` trio first joins a multi-process job via
    :func:`init_multihost`, then shards over every process's devices;
    ``--dcn-coordinator auto`` reads the job from the environment
    (torchrun's variables)."""
    dcn = (cfg.dcn_coordinator, cfg.dcn_num_processes, cfg.dcn_process_id)
    if any(v is not None for v in dcn):
        if cfg.dcn_coordinator == "auto":
            init_multihost(device=device)
        elif None in dcn:
            raise ValueError(
                "multi-host needs all three of --dcn-coordinator, "
                "--dcn-processes and --dcn-process-id (or "
                "--dcn-coordinator auto under torchrun)")
        else:
            init_multihost(*dcn, device=device)
        if cfg.shard_devices is None:
            return make_mesh(None, device, cfg.mesh_axis)  # every global device
    if cfg.shard_devices is None:
        return None
    return make_mesh(cfg.shard_devices or None, device, cfg.mesh_axis)


def shard_rows(x: torch.Tensor, mesh: Mesh, rows_per_shard: Optional[int] = None,
               fill: float = 0.0) -> tuple:
    """This process's blocks of the (N, ...) rows, each on its shard's
    device: block g is rows ``g * r .. g * r + r - 1``, r = N / mesh.size
    unless given. A block short of r rows (past N) is filled with
    ``fill``. On a one-process mesh of one device the blocks are views of
    ``x``; otherwise copies, so ``x`` can be freed."""
    n = x.shape[0]
    if rows_per_shard is None:
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split into {mesh.size} shards (pad first)")
        rows_per_shard = n // mesh.size
    r = rows_per_shard
    copy = not (mesh.one_device and mesh.world == 1)
    out = []
    for s, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + s) * r
        blk = x[lo:lo + r]
        if blk.shape[0] < r:
            pad = torch.full((r - blk.shape[0], *x.shape[1:]), fill, dtype=x.dtype,
                             device=x.device)
            blk = torch.cat([blk, pad])
        out.append(blk.to(dev, copy=copy))
    return tuple(out)


def replicate(x: torch.Tensor, mesh: Mesh) -> tuple:
    """``x`` on every shard's device (the same tensor where it lives)."""
    return tuple(x.to(dev) for dev in mesh.devices)


def all_gather_processes(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` from every process, in rank order, on ``t``'s device: one
    collective over the mesh's data group (through host memory when
    staged). ``[t]`` on a mesh of one process without a group."""
    if mesh.group is None:
        return [t]
    src = (t.cpu() if mesh.staged else t).contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device) for o in out]


def all_reduce_processes(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over every process, on ``t``'s device."""
    if mesh.group is None:
        return t
    buf = (t.cpu() if mesh.staged else t).contiguous().clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)
