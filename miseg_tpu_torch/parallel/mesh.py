"""Data parallelism, one process a card (counterpart of
`miseg_tpu/parallel/mesh.py`).

The reference's only parallelism is data parallel (PTL DDP, its
train.py:47; manual DDP with a `DistributedSampler` in its tune.py).  The
JAX package runs it as one process (host) a device over a 1-D "data"
mesh; the port runs the same semantics over a `torch.distributed`
process group, one rank a card, started by `torchrun`:

  * `cfg.batch_size` is per process; the global batch is `batch_size x
    world`.  The train loader is sharded by `(rank, world)` with
    `DistributedSampler`'s padding; validation and test loaders are not
    (every rank evaluates every volume, so all agree on the metrics).
  * The gradient is the mean over the global batch: each rank's gradient
    of its local mean loss, averaged over ranks (`all_reduce_mean`, in
    buckets, once a window under gradient accumulation).
  * Batch norm's training statistics cover the global batch
    (`batch_stats`): each rank's (count, mean, M2) merged by Chan's
    formula, with a backward that carries the cross-rank terms.
  * Rank 0's initial parameters are broadcast (`broadcast_tensors`); rank
    0 alone writes checkpoints and metrics, and the others wait at a
    barrier.

`init_process_group` joins the group `torchrun` describes (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`) whenever the
process runs under it, one rank included: NCCL on the card, gloo on the
CPU.  A run whose backend fails raises; no single-process fallback
exists.  A process that joined a group itself (the CPU tests, with a
`file://` rendezvous) is used as it is.  Every collective here does
nothing in a process without a group, so callers never ask.

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

import os
from collections.abc import Sequence

import torch
import torch.distributed as dist

from ..ops import norms as N
from ..utils.platform import resolve_device

BUCKET_BYTES = 25 << 20   # gradient all-reduce bucket, DistributedDataParallel's default


def group():
    """The data-parallel process group (the default one) when this process
    joined one, else None: one process without a group computes the same
    function with no collective."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def host_shard_info() -> tuple[int, int]:
    """(shard, num_shards) for the per-rank train loader: (rank, world)."""
    if group() is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Whether this process writes checkpoints, metrics and journals:
    rank 0, or the only process."""
    return host_shard_info()[0] == 0


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
    if group() is not None:
        dist.destroy_process_group()


def check_mesh(cfg, entry: str = "Trainer") -> None:
    """The mesh the port runs: one "data" axis over every rank (`[-1]`, or
    `[world]`).  Any other shape or axis raises `NotImplementedError` from
    `entry` (the model, tensor and pipeline axes wait for ROADMAP M11)."""
    world = host_shard_info()[1]
    shape, axes = list(cfg.mesh_shape), list(cfg.mesh_axes)
    bad = ([f"mesh_shape={shape!r}"] if shape not in ([-1], [world]) else []) + (
        [f"mesh_axes={axes!r}"] if axes != ["data"] else [])
    if bad:
        raise NotImplementedError(
            f"{entry}: {', '.join(bad)}: the port runs a 1-D 'data' mesh over its {world} "
            f"rank(s) (mesh_shape [-1] or [{world}], mesh_axes ['data']); other meshes "
            "wait for ROADMAP M11")


def broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` with rank 0's, in place."""
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


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place.  Tensors
    are flattened into buckets of up to `BUCKET_BYTES` by dtype, one
    collective a bucket: NCCL's AVG where the backend offers it, else a
    SUM divided by the world size (gloo)."""
    if group() is None:
        return
    world = dist.get_world_size()
    avg = dist.get_backend() == dist.Backend.NCCL
    op = dist.ReduceOp.AVG if avg else dist.ReduceOp.SUM
    with torch.no_grad():
        for bucket in _buckets(tensors, BUCKET_BYTES):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=op)
            if not avg:
                flat.div_(world)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


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
    """(mean, var) `[C]` of `[..., C]` over every rank's elements: each
    rank's (count, mean, M2) all-gathered and merged by Chan's formula.
    The backward sums the statistics' cotangents over the ranks (every
    rank's loss reads the global statistics), then takes this rank's
    part: `dx = (g_mean + 2 (x - mean) g_var) / N`."""

    @staticmethod
    def forward(ctx, x):
        c = x.shape[-1]
        x32 = x.detach().float().reshape(-1, c)
        n = torch.full((1, c), float(x32.shape[0]), device=x.device)
        mean = x32.mean(0, keepdim=True)
        m2 = (x32 - mean).square().sum(0, keepdim=True)
        parts = [torch.empty(3, c, device=x.device) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, torch.cat([n, mean, m2]))
        counts, means, m2s = torch.stack(parts).unbind(1)          # [R, C] each
        total = counts.sum(0)
        g_mean = (counts * means).sum(0) / total
        g_m2 = m2s.sum(0) + (counts * (means - g_mean).square()).sum(0)
        var = (g_m2 / total).clamp_min(0.0)
        ctx.save_for_backward(x, g_mean, total)
        return g_mean, var

    @staticmethod
    def backward(ctx, d_mean, d_var):
        x, mean, total = ctx.saved_tensors
        c = x.shape[-1]
        g = torch.cat([torch.zeros(c, device=x.device) if d_mean is None else d_mean,
                       torch.zeros(c, device=x.device) if d_var is None else d_var])
        dist.all_reduce(g)
        d_mean, d_var = g[:c] / total, g[c:] / total
        dx = d_mean + 2.0 * (x.float() - mean) * d_var
        return dx.to(x.dtype)


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (mean, var) `[C]` of `[B, *spatial, C]` over the
    batch and spatial dims of every rank's `x`; differentiable.  Without a
    group, the one process's (`ops.norms.batch_stats`, flax's one pass)."""
    if group() is None:
        return N.batch_stats(x)
    return _GlobalBatchStats.apply(x)
