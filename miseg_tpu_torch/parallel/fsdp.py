"""FSDP (ZeRO-3) sharding of the f32 masters and their optimizer state over
an axis of the mesh (counterpart of `miseg_tpu/parallel/fsdp.py`), and the
sharded state both FSDP and tensor parallelism (`tensor.py`) place.

Which leaves shard is JAX's rule (`leaf_spec`, miseg_tpu/parallel/fsdp.py:
36-51), applied in flax's layout and mapped onto the port's dims through
the bridge's permutation (`weights.flax_dims`): a leaf of fewer than
`fsdp_min_size` elements stays replicated; otherwise the largest dim
divisible by the axis size shards, the last one on a tie.  So the port
shards the same leaves as JAX, on the counterpart dims.

How a step runs (`placements`, `gather_for_step`, the Trainer):
  * each rank holds its f32 shard of a sharded leaf as the master; the
    optimizer (AdamW, elementwise) and `Accumulation` run on the shards,
    so the moments follow the parameters;
  * the step casts the shards to the compute dtype and all-gathers them
    over the FSDP axis' line, once a step, in one collective a line,
    outside the autograd graph, into leaves whose gradients are summed in
    f32 as the backward lands (in one call, or in the pipeline schedule's
    many, a different number on each stage);
  * after the backward one reduce-scatter a line hands each shard the
    gradient of the global batch's mean loss: where the FSDP axis is
    "data" (its ranks hold different batches) with the mean; where it is
    another axis whose ranks share a batch, so they hold one gradient,
    the rank's slice; where it is the spatial line of a partitioned patch
    (`spatial.py`, D7: each rank holds its slab's part of every gradient)
    or the pipeline line (each stage its part) with the sum.  The rest of
    the leaf's axes follow the replicated leaves' rule afterwards
    (`Trainer._reduce_grads`, D11: a leaf sharded on "data" is summed
    over the pipeline or spatial line, averaged over a line of copies;
    the others averaged over "data").  No part is left out or counted
    twice;
  * tensor parallelism's leaves on an axis whose ranks hold different
    activations (`megatron_axis`: "data", the spatial or the pipeline
    axis) take the same path, with their own dims: JAX places them so and
    GSPMD computes the one-process function (ROADMAP D13);
  * evaluation and checkpoints gather whole tensors (`gather_full`),
    and loading a whole tensor keeps the rank's slice (`Placement.shard`),
    so a checkpoint is one process's, whatever the mesh.

JAX lets GSPMD insert these collectives; the port issues them itself:
gloo (CPU) has no reduce-scatter, so there it is an all-reduce of the
stacked shards of which each rank keeps its own.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..weights import flax_dims


def leaf_spec(shape: Sequence[int], n: int, min_size: int = 8192) -> int | None:
    """The dim of a flax-layout leaf to shard `n` ways (the largest
    divisible by `n`, the last on a tie), or None to replicate it (`n` <=
    1, a scalar, fewer than `min_size` elements, or no divisible dim)."""
    if n <= 1 or not shape or int(np.prod(shape)) < min_size:
        return None
    best = -1
    for d, s in enumerate(shape):
        if s % n == 0 and (best < 0 or s >= shape[best]):
            best = d
    return None if best < 0 else best


def to_port_dim(name: str, shape: Sequence[int], flax_rule) -> int | None:
    """`flax_rule(flax_shape)` (a flax dim or None) for the port's tensor
    `name` of `shape`, as the port's dim."""
    perm = flax_dims(name, len(shape))
    flax_shape = [0] * len(shape)
    for j, d in enumerate(perm):
        flax_shape[d] = shape[j]
    d = flax_rule(tuple(flax_shape))
    return None if d is None else perm.index(d)


def shard_dim(name: str, shape: Sequence[int], n: int, min_size: int = 8192) -> int | None:
    """The port's dim of `name` that FSDP shards `n` ways, or None."""
    return to_port_dim(name, shape, lambda s: leaf_spec(s, n, min_size))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf split `size` ways along `dim` over the mesh axis `axis`, this
    rank holding piece `index`; `group` is the axis' line through this
    rank.  `kind` says how a step uses the piece: "tp", the Megatron
    layers run on it; "fsdp", it is gathered whole once a step and its
    gradient reduce-scattered (FSDP's leaves, and tensor parallelism's
    where the axis' ranks hold different batches, slabs or stages)."""
    kind: str
    dim: int
    axis: str
    index: int
    size: int
    group: object = dataclasses.field(compare=False)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor `full` (a view)."""
        k = full.shape[self.dim] // self.size
        return full.narrow(self.dim, self.index * k, k)


def megatron_axis(cfg) -> bool:
    """Whether the Megatron layers can run over `cfg.tp_axis`: its ranks
    must hold the same activations, so the axis is not "data" (different
    batches), the spatial axis of `spatial_shard` (different slabs) or
    the pipeline axis of `pipeline_parallel` (different stages).  On such
    an axis tensor parallelism keeps its placement and gathers its leaves
    whole once a step, as FSDP does (ROADMAP D13)."""
    others = {"data"}
    if cfg.spatial_shard:
        others.add(cfg.spatial_axis)
    if cfg.pipeline_parallel:
        others.add(cfg.pp_axis)
    return cfg.tp_axis not in others


def placements(shapes: Mapping[str, Sequence[int]], mesh, cfg) -> dict[str, Placement]:
    """The sharded leaves of a state dict's parameters (`name -> shape`)
    under `cfg` on `mesh`, as JAX places them (miseg_tpu/train/engine.py:
    193-212): a mode is on only where its axis has more than one rank;
    tensor parallelism (`tensor.tp_dim`) claims the transformer matmuls
    (kind "tp", or "fsdp" off a `megatron_axis`) and, with FSDP on too,
    the leaves it leaves unclaimed shard on `fsdp_axis`; FSDP alone shards
    by `shard_dim`.  A leaf absent from the result is replicated."""
    from .tensor import tp_dim
    n_tp = mesh.size(cfg.tp_axis) if cfg.tensor_parallel else 1
    n_fs = mesh.size(cfg.fsdp_axis) if cfg.fsdp else 1
    tp_kind = "tp" if megatron_axis(cfg) else "fsdp"
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        dim = tp_dim(name, shape, n_tp) if n_tp > 1 else None
        if dim is not None:
            out[name] = Placement(tp_kind, dim, cfg.tp_axis, mesh.index(cfg.tp_axis), n_tp,
                                  mesh.group(cfg.tp_axis))
            continue
        dim = shard_dim(name, shape, n_fs, cfg.fsdp_min_size) if n_fs > 1 else None
        if dim is not None:
            out[name] = Placement("fsdp", dim, cfg.fsdp_axis, mesh.index(cfg.fsdp_axis), n_fs,
                                  mesh.group(cfg.fsdp_axis))
    return out


def _all_gather_rows(flat: torch.Tensor, pl: Placement) -> torch.Tensor:
    """`[size, numel]`: every rank's `flat` of the placement's line."""
    out = torch.empty((pl.size, flat.numel()), dtype=flat.dtype, device=flat.device)
    if dist.get_backend(pl.group) == dist.Backend.NCCL:
        dist.all_gather_into_tensor(out, flat, group=pl.group)
    else:
        dist.all_gather(list(out.unbind(0)), flat, group=pl.group)
    return out


def _join(rows: torch.Tensor, shards: Sequence[torch.Tensor],
          pls: Sequence[Placement]) -> list[torch.Tensor]:
    """The whole tensors from the gathered rows (`[size, sum of shard
    numels]`, row k the shards of rank k, flattened and concatenated)."""
    out, offset = [], 0
    for s, pl in zip(shards, pls):
        pieces = [r[offset:offset + s.numel()].view(s.shape) for r in rows]
        out.append(torch.cat(pieces, dim=pl.dim))
        offset += s.numel()
    return out


def _pieces(grads, meta, pls: Sequence[Placement], reduce: str | None,
            device) -> list[torch.Tensor]:
    """This rank's pieces (shapes and dtypes `meta`) of the whole leaves'
    gradients `grads` of one line (None: zeros), from their f32 values in
    one collective: `reduce` "mean" or "sum" reduce-scatters them so, None
    (the line's ranks hold one gradient) takes this rank's piece."""
    pl = pls[0]
    rows = []
    for g, (shape, _), p in zip(grads, meta, pls):
        if g is None:
            rows.append(torch.zeros((p.size, shape.numel()), device=device))
        else:
            rows.append(torch.stack(g.float().chunk(p.size, dim=p.dim)).reshape(p.size, -1))
    buf = torch.cat(rows, dim=1)                      # [size, sum of shard numels]
    if reduce is not None:
        if dist.get_backend(pl.group) == dist.Backend.NCCL:
            mine = torch.empty(buf.shape[1], device=buf.device)
            op = dist.ReduceOp.AVG if reduce == "mean" else dist.ReduceOp.SUM
            dist.reduce_scatter_tensor(mine, buf.reshape(-1), op=op, group=pl.group)
        else:
            dist.all_reduce(buf, group=pl.group)
            mine = buf[pl.index] / pl.size if reduce == "mean" else buf[pl.index]
    else:
        mine = buf[pl.index]
    out, offset = [], 0
    for shape, dtype in meta:
        out.append(mine[offset:offset + shape.numel()].view(shape).to(dtype))
        offset += shape.numel()
    return out


def _lines(tensors: Mapping[str, torch.Tensor], pls: Mapping[str, Placement]) -> dict:
    """The names of `tensors` that `pls` places, by the line they gather
    over and their dtype."""
    lines: dict = {}
    for n, t in tensors.items():
        if n in pls:
            lines.setdefault((pls[n].kind, pls[n].axis, t.dtype), []).append(n)
    return lines


@torch.no_grad()
def full_weights(params: Mapping[str, torch.Tensor], pls: Mapping[str, Placement],
                 dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every floating leaf of `params` (f32 masters, shards where `pls`
    places them) in `dtype`, whole: the placed ones, FSDP's and tensor
    parallelism's, gathered (evaluation; every rank calls)."""
    return gather_full({n: p.to(dtype) if p.is_floating_point() else p
                        for n, p in params.items()}, pls)


def gather_for_step(params: Mapping[str, torch.Tensor], pls: Mapping[str, Placement],
                    dtype: torch.dtype, ops: Mapping[str, str | None]):
    """The weights of a training step and their way back.  Returns
    `(weights, scatter)`: every floating leaf of `params` in `dtype`, the
    tensor-parallel shards as they are (the Megatron layers take them),
    the FSDP lines gathered whole once, outside the autograd graph, into
    leaves that require grad, whose gradients are summed in f32 as the
    backward calls land (one, or the pipeline schedule's many, a different
    number on each stage); and `scatter()`, to call once after the last
    of them on every rank, which reduce-scatters each line's gradients in
    one collective, in the same order everywhere (`ops[axis]`: "mean",
    "sum", or None for this rank's piece, `_pieces`' `reduce`) and adds
    each master's piece to its `.grad`."""
    out = {n: p.to(dtype) if p.is_floating_point() else p for n, p in params.items()
           if n not in pls}
    lines = []
    for (kind, axis, _), names in _lines(params, pls).items():
        if kind == "tp":
            out.update({n: params[n].to(dtype) for n in names})
            continue
        line = tuple(pls[n] for n in names)
        shards = [params[n] for n in names]
        with torch.no_grad():
            flat = torch.cat([s.detach().to(dtype).reshape(-1) for s in shards])
            whole = _join(_all_gather_rows(flat, line[0]), shards, line)
        sums: list = [None] * len(whole)
        for k, w in enumerate(whole):
            w.requires_grad_()
            w.register_post_accumulate_grad_hook(functools.partial(_fold, sums, k))
        out.update(zip(names, whole))
        lines.append((names, line, sums, ops.get(axis)))

    def scatter() -> None:
        for names, line, sums, reduce in lines:
            meta = [(params[n].shape, params[n].dtype) for n in names]
            for n, g in zip(names, _pieces(sums, meta, line, reduce, params[names[0]].device)):
                p = params[n]
                p.grad = g if p.grad is None else p.grad + g

    return out, scatter


def _fold(sums: list, k: int, leaf: torch.Tensor) -> None:
    """Move the gradient just accumulated into `leaf` into `sums[k]`, in f32."""
    g = leaf.grad.float()
    sums[k] = g if sums[k] is None else sums[k].add_(g)
    leaf.grad = None


def _gather_rows_to(flat: torch.Tensor, pl: Placement, dst: int) -> torch.Tensor | None:
    """`[size, numel]` on global rank `dst` (every rank's `flat` of the
    placement's line), None on the line's other ranks."""
    rows = torch.empty((pl.size, flat.numel()), dtype=flat.dtype, device=flat.device)
    mine = dist.get_rank() == dst
    dist.gather(flat, list(rows.unbind(0)) if mine else None, dst=dst, group=pl.group)
    return rows if mine else None


@torch.no_grad()
def gather_full(tensors: Mapping[str, torch.Tensor], pls: Mapping[str, Placement],
                dst: int | None = None) -> dict[str, torch.Tensor] | None:
    """`tensors` by name, whole: the placed ones (shards, or state of the
    same shape, such as AdamW's moments) gathered in their own dtype, one
    collective a line; the others as they are.  Every rank gets them, or
    with `dst` only global rank `dst` (a writer), the others None: the
    lines through `dst` gather to it, and the other lines, which hold the
    same values, do nothing."""
    out = {n: t for n, t in tensors.items() if n not in pls}
    for names in _lines(tensors, pls).values():
        shards = [tensors[n] for n in names]
        line = [pls[n] for n in names]
        flat = torch.cat([s.reshape(-1) for s in shards])
        if dst is None:
            rows = _all_gather_rows(flat, line[0])
        elif dst in dist.get_process_group_ranks(line[0].group):
            rows = _gather_rows_to(flat, line[0], dst)
        else:
            rows = None
        if rows is not None:
            out.update(zip(names, _join(rows, shards, line)))
    if dst is not None and dist.is_initialized() and dist.get_rank() != dst:
        return None
    return {n: out[n] for n in tensors}
