"""The mesh of ranks and data parallelism, one process a card (counterpart
of `miseg_tpu/parallel/mesh.py`).

The reference's only parallelism is data parallel (PTL DDP, its
train.py:47; manual DDP with a `DistributedSampler` in its tune.py).  The
JAX package runs it as one process (host) a device over a 1-D "data"
mesh, and lays FSDP and tensor parallelism over further axes of the same
mesh; the port runs the same semantics over `torch.distributed` process
groups, one rank a card, started by `torchrun`.

The mesh (`make_mesh`, `mesh_from_config`) follows JAX's `make_mesh`
(miseg_tpu/parallel/mesh.py:27-37): `mesh_shape` with one `-1` inferred
from the world size, a product other than the world size a `ValueError`,
and `mesh_axes` naming each axis, any name.  Rank r takes its coordinates
row-major, the order in which JAX reshapes `jax.devices()`, so the ranks
of one line of the last axis ("model") are adjacent.  Each line along
each axis is one process group, created with `dist.new_group` in the same
order on every rank (a line of every rank is the world group).  The modes
claim their axes ("data", `cfg.fsdp_axis`, `cfg.tp_axis`, `cfg.pp_axis`,
under `cfg.spatial_shard` `cfg.spatial_axis`); an axis no mode claims
holds copies, as JAX replicates over it.  Every mode runs beside every
other; the meshes JAX itself refuses raise what JAX raises (at the
Trainer's first step: a mesh of more than one rank with neither a "data"
axis nor a spatial line, JAX's `shard_batch`; a pipeline or a patch's D
on "data").
Besides the lines, every sub-mesh of two or more axes of more than one
rank has a group (`Mesh.subgroup`), for a gradient that is summed over
one axis and averaged over another in one collective.

  * `cfg.batch_size` is per data coordinate: the train loader is sharded
    by `(data index, data size)` (`host_shard_info`), so the ranks of one
    line of the other axes load the same batch and draw the same dropout
    masks.  Validation and test loaders are not sharded: every rank
    evaluates every volume, its window groups fanned out over the line of
    the mesh's first axis (`SlidingWindowInferer`'s `mesh`, JAX's rule;
    each rank predicts its share, `all_gather_line` hands every rank all
    of them), so all agree on the logits and the metrics.
  * The gradient is the mean over the global batch: each rank's gradient
    of its local mean loss, averaged over the "data" line
    (`all_reduce_mean`, in buckets, once a window under gradient
    accumulation); a leaf FSDP shards over "data" is averaged by its
    gather's reduce-scatter instead (`fsdp.py`).  Under pipeline
    parallelism each stage holds its leaves' part of the gradient and
    zeros for the rest, and under spatial partitioning each rank its
    slab's part, so one all-reduce over the sub-mesh of the pipeline or
    spatial line and "data" sums the one and averages the other
    (`all_reduce_mean(..., over=data size)`); a line whose ranks hold
    copies (a "model" line) is averaged like "data", so the copies stay
    bitwise equal, and each FSDP leaf's reduce-scatter takes its axis'
    share: the rule by axis role is `Trainer._reduce_grads`'.
  * Batch norm's training statistics cover the global batch
    (`batch_stats`): each data rank's (count, mean, M2) merged by Chan's
    formula over the "data" line (over every rank it would count a shared
    batch twice), with a backward that carries the cross-rank terms; under
    spatial partitioning over the data x spatial ranks (every rank), which
    hold the global batch's slabs.
  * Rank 0's initial parameters are broadcast (`broadcast_tensors`); rank
    0 alone writes checkpoints and metrics (`is_writer`), and the others
    wait at a barrier.

`init_process_group` joins the group `torchrun` describes (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`) whenever the
process runs under it, one rank included: NCCL on the card, gloo on the
CPU.  A run whose backend fails raises; no single-process fallback
exists.  A process that joined a group itself (the CPU tests, with a
`file://` rendezvous) is used as it is.  Every collective here does
nothing in a process without a group, or on an axis of size 1, so
callers never ask.

Why not `DistributedDataParallel`'s reducer: the Trainer's gradients
land in the f32 masters through a functional call, and its accumulation
(`train/optim.py` `Accumulation`, optax `MultiSteps`' numerics) clears
`.grad` each micro-step and keeps the window's running mean apart.  DDP
all-reduces `.grad` during the backward, so under `no_sync` it would
reduce the last micro-step's gradient, not the window's mean; the
window's all-reduce has to be this one anyway, and one path serves both.
The cost is that the all-reduce follows the backward instead of
overlapping it (ROADMAP Queue 2).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import norms as N
from ..utils.platform import resolve_device
from . import spatial

BUCKET_BYTES = 25 << 20   # gradient all-reduce bucket, DistributedDataParallel's default


def group():
    """The world's process group when this process joined one, else None:
    one process without a group computes the same function with no
    collective."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh of ranks: the mesh's `shape` and `axes`,
    the rank's `coords` (row-major), and the process group of its line
    along each axis (None without a group, or for a line of one rank
    that is not the whole world)."""
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    coords: tuple[int, ...]
    groups: dict = dataclasses.field(compare=False)

    def size(self, axis: str | None) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def index(self, axis: str | None) -> int:
        """This rank's coordinate on the axis; 0 for one it does not have."""
        return self.coords[self.axes.index(axis)] if axis in self.axes else 0

    def group(self, axis: str | None):
        """The process group of this rank's line along the axis, or None."""
        return self.groups.get(axis)

    def subgroup(self, axes) -> object:
        """The process group of the sub-mesh through this rank that spans
        `axes` (the ranks sharing this rank's coordinates on every other
        axis), or None.  Axes whose line has no group (a line of one rank
        that is not the whole world) drop out; one axis left is its line's
        group."""
        axes = tuple(a for a in self.axes if a in axes and self.group(a) is not None)
        if len(axes) <= 1:
            return self.group(axes[0]) if axes else None
        if math.prod(self.size(a) for a in axes) == math.prod(self.shape):
            return dist.group.WORLD
        return self.groups[axes]

    def line(self, axis: str | None) -> tuple[int, ...]:
        """The global ranks of this rank's line along the axis, in the
        order of their coordinate on it (this rank alone for an axis the
        mesh does not have)."""
        if axis not in self.axes:
            return (int(np.ravel_multi_index(self.coords, self.shape)),)
        a = self.axes.index(axis)
        return tuple(int(np.ravel_multi_index((*self.coords[:a], k, *self.coords[a + 1:]),
                                              self.shape)) for k in range(self.shape[a]))


_meshes: dict = {}
_active: Mesh | None = None


def _world() -> tuple[int, int]:
    if group() is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",)) -> Mesh:
    """This rank's `Mesh` of `shape` over `axes` (JAX's `make_mesh` rules:
    one -1 inferred from the world size; `ValueError` for a product other
    than the world size, or as many sizes as names differing).  Built once
    a shape per world group: its process groups are created by every rank
    in the same order, so every rank must ask for the same meshes in the
    same order."""
    rank, world = _world()
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh_shape {list(shape)} and mesh_axes {list(axes)} must name "
                         "one axis a size, each name once")
    if shape.count(-1) == 1:
        known = math.prod(s for s in shape if s != -1) or 1
        shape = tuple(world // known if s == -1 else s for s in shape)
    if math.prod(shape) != world or min(shape) < 1:
        raise ValueError(f"mesh shape {list(shape)} != {world} ranks")
    key = (shape, axes, id(group()))
    if key in _meshes:
        return _meshes[key]
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = dict.fromkeys(axes)
    for a, axis in enumerate(axes):
        if group() is None:
            continue
        # the world's group where the line is every rank (one rank under
        # torchrun included: its collectives still run), none for another
        # line of one rank
        for ranks in _sub_meshes(shape, (a,)):
            g = (dist.group.WORLD if len(ranks) == world else
                 None if len(ranks) == 1 else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = g
    # a group for each sub-mesh of two or more axes of more than one rank
    # that is not the world (`Mesh.subgroup`), in the same order on every rank
    big = [a for a, s in enumerate(shape) if s > 1]
    subsets = [dims for n in range(2, len(big) + 1) for dims in itertools.combinations(big, n)
               if math.prod(shape[d] for d in dims) < world]
    for dims in subsets if group() is not None else ():
        for ranks in _sub_meshes(shape, dims):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[tuple(axes[d] for d in dims)] = g
    _meshes[key] = Mesh(shape, axes, coords, groups)
    return _meshes[key]


def _sub_meshes(shape: tuple[int, ...], dims: tuple[int, ...]) -> list[list[int]]:
    """The global ranks of each sub-mesh spanning `dims` of a mesh of
    `shape`, one list a coordinate of the other dims (row-major), each in
    row-major order."""
    rest = [d for d in range(len(shape)) if d not in dims]
    ranks = np.arange(math.prod(shape)).reshape(shape).transpose(*rest, *dims)
    return ranks.reshape(-1, math.prod(shape[d] for d in dims)).tolist()


def mesh_from_config(cfg) -> Mesh:
    """`cfg`'s mesh (`mesh_shape`, `mesh_axes`) over the ranks, made the
    active one.  Any axis names are taken, as JAX's `make_mesh` takes them:
    the modes claim theirs, and the ranks of an axis no mode claims hold
    copies (ROADMAP D11, D13)."""
    global _active
    _active = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    return _active


def active() -> Mesh:
    """The active mesh, the one `host_shard_info`, `data_group` and the
    collectives below follow: the last `mesh_from_config` made (a
    Trainer's, or a command line's before its loaders); without one,
    "data" over every rank."""
    if _active is not None:
        return _active
    return make_mesh((-1,), ("data",))


def data_group():
    """The process group of this rank's "data" line, or None."""
    return active().group("data") if group() is not None else None


def host_shard_info() -> tuple[int, int]:
    """(shard, num_shards) for the train loader and the dropout masks: the
    rank's "data" coordinate and the "data" size (the ranks of one line of
    the other axes share a batch)."""
    if group() is None:
        return 0, 1
    mesh = active()
    return mesh.index("data"), mesh.size("data")


def is_writer() -> bool:
    """Whether this process writes checkpoints, metrics and journals:
    rank 0, or the only process."""
    return _world()[0] == 0


def barrier() -> None:
    if group() is not None:
        dist.barrier()


def init_process_group(device=None, *, no_gpu: bool = False) -> torch.device:
    """The device this process runs on, after joining `torchrun`'s process
    group when it runs under `torchrun` (`RANK` and `WORLD_SIZE` set, at
    any world size): backend NCCL for a CUDA device, gloo for the CPU; the
    CUDA device is `cuda:LOCAL_RANK` unless the caller names an index.
    Raises when the group cannot be set up."""
    dev = resolve_device(device, no_gpu=no_gpu)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if torchrun and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if torchrun and not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=world,
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def destroy_process_group() -> None:
    """Leave the group this process joined, if any (a command line's
    last act, so NCCL's resources are released before exit)."""
    global _active
    if group() is not None:
        _active = None
        _meshes.clear()
        dist.destroy_process_group()


def broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` with (global) rank 0's, in place."""
    if group() is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (`obj` elsewhere is ignored)."""
    if group() is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_mean(tensors: Sequence[torch.Tensor], pg="data", *,
                    over: int | None = None) -> None:
    """Replace each tensor by its mean over the ranks of `pg` (a process
    group, or the name of an axis of the active mesh: by default this
    rank's "data" line; None: nothing to do), in place; with `over`, by
    the sum over the ranks divided by `over`.  Tensors are flattened into
    buckets of up to `BUCKET_BYTES` by dtype, one collective a bucket:
    NCCL's AVG where the backend offers it and `over` is not given, else a
    SUM divided by the group's size or `over`."""
    if isinstance(pg, str):
        pg = active().group(pg) if group() is not None else None
    if pg is None or not tensors:
        return
    world = dist.get_world_size(pg) if over is None else over
    avg = over is None and dist.get_backend(pg) == dist.Backend.NCCL
    op = dist.ReduceOp.AVG if avg else dist.ReduceOp.SUM
    with torch.no_grad():
        for bucket in _buckets(tensors, BUCKET_BYTES):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=op, group=pg)
            if not avg:
                flat.div_(world)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_gather_line(t: torch.Tensor, pg) -> torch.Tensor:
    """`[size, *t.shape]`: every rank's `t` over the process group `pg` (a
    line of the mesh), row k the rank of coordinate k on it, on `t`'s
    device.  NCCL gathers in place; gloo moves host memory only (ROADMAP
    D6), so a CUDA tensor goes through pinned host memory and back."""
    n = dist.get_world_size(pg)
    t = t.contiguous()
    if dist.get_backend(pg) == dist.Backend.NCCL:
        out = t.new_empty((n, *t.shape))
        dist.all_gather_into_tensor(out, t, group=pg)
        return out
    pinned = t.device.type == "cuda"
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned).copy_(t)
    out = torch.empty((n, *t.shape), dtype=t.dtype, pin_memory=pinned)
    dist.all_gather(list(out.unbind(0)), host, group=pg)
    return out.to(t.device)


def _buckets(tensors, bucket_bytes):
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for same in by_dtype.values():
        bucket, size = [], 0
        for t in same:
            nbytes = t.numel() * t.element_size()
            if bucket and size + nbytes > bucket_bytes:
                yield bucket
                bucket, size = [], 0
            bucket.append(t)
            size += nbytes
        if bucket:
            yield bucket


class _GlobalBatchStats(torch.autograd.Function):
    """(mean, var) `[C]` of `[..., C]` over the elements of every rank of
    the group `pg` (the "data" line): each rank's (count, mean, M2)
    all-gathered and merged by Chan's formula.  The backward sums the
    statistics' cotangents over those ranks (every rank's loss reads the
    global statistics), then takes this rank's part:
    `dx = (g_mean + 2 (x - mean) g_var) / N`."""

    @staticmethod
    def forward(ctx, x, pg):
        c = x.shape[-1]
        x32 = x.detach().float().reshape(-1, c)
        n = torch.full((1, c), float(x32.shape[0]), device=x.device)
        mean = x32.mean(0, keepdim=True)
        m2 = (x32 - mean).square().sum(0, keepdim=True)
        parts = [torch.empty(3, c, device=x.device) for _ in range(dist.get_world_size(pg))]
        dist.all_gather(parts, torch.cat([n, mean, m2]), group=pg)
        counts, means, m2s = torch.stack(parts).unbind(1)          # [R, C] each
        total = counts.sum(0)
        g_mean = (counts * means).sum(0) / total
        g_m2 = m2s.sum(0) + (counts * (means - g_mean).square()).sum(0)
        var = (g_m2 / total).clamp_min(0.0)
        ctx.save_for_backward(x, g_mean, total)
        ctx.pg = pg
        return g_mean, var

    @staticmethod
    def backward(ctx, d_mean, d_var):
        x, mean, total = ctx.saved_tensors
        c = x.shape[-1]
        g = torch.cat([torch.zeros(c, device=x.device) if d_mean is None else d_mean,
                       torch.zeros(c, device=x.device) if d_var is None else d_var])
        dist.all_reduce(g, group=ctx.pg)
        d_mean, d_var = g[:c] / total, g[c:] / total
        dx = d_mean + 2.0 * (x.float() - mean) * d_var
        return dx.to(x.dtype), None


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (mean, var) `[C]` of `[B, *spatial, C]` over the
    batch and spatial dims of `x` on every rank of this rank's "data"
    line (under spatial partitioning, of every rank: the data x spatial
    ranks); differentiable.  Without one, this process's
    (`ops.norms.batch_stats`, flax's one pass)."""
    pg = group() if spatial.active() is not None else data_group()
    if pg is None:
        return N.batch_stats(x)
    return _GlobalBatchStats.apply(x, pg)
