"""Tensor parallelism: Megatron's sharding of the transformer matmuls over
an axis of the mesh (counterpart of `miseg_tpu/parallel/tensor.py`).

Which leaves shard is JAX's `tp_leaf_spec` (miseg_tpu/parallel/tensor.py:
50-84), by the name of the Linear holding them and the flax layout,
mapped onto the port's dims (`weights.flax_dims`; a Linear's torch
weight is `[out, in]`):
  * MLP `linear1`: column-parallel, its weight's dim 0 (out) and its bias
    shard;
  * MLP `linear2`: row-parallel, its weight's dim 1 (in) shards; its bias
    is replicated and added after the reduce;
  * attention `qkv` and `proj`, and swin `PatchMerging.reduction`:
    row-parallel on the input dim.
Only rank-2 weights are claimed (swin's PatchEmbed `proj` is a conv and
stays unclaimed), and only where the sharded dim divides the axis size.

JAX lets GSPMD insert the collectives; the port runs Megatron's f and g
as autograd Functions over the axis' line (`nn.layers.Linear` calls them
when the trainer hands it a shard of its weight):
  * column-parallel (`copy_to`, f): the replicated input as it is, its
    gradient all-reduced over the line; the output is the rank's columns;
  * row-parallel (`reduce_from`, g): the local product all-reduced, its
    gradient as it is.  On a replicated input (qkv, proj, reduction) the
    layer first takes its slice of the input's columns (`slice_columns`),
    whose backward all-gathers the slices' gradients back to the full
    width.
The ranks of one line share a batch (the "data" coordinate) and, under
spatial partitioning, a slab (the spatial coordinate), so their
activations, norms, dropout masks and replicated leaves' gradients are
the same; K5 runs on the all-reduced, replicated qkv.  A TP axis whose
ranks hold different activations ("data", the spatial or the pipeline
axis) runs no Megatron layer: its leaves are gathered once a step as
FSDP's (`fsdp.megatron_axis`, ROADMAP D13).
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .fsdp import Placement, to_port_dim

# module name -> role: "col" shards the flax kernel's out dim (and the
# bias), "row" its in dim
_ROLES = {"linear1": "col", "linear2": "row", "qkv": "row", "proj": "row",
          "reduction": "row"}


def tp_leaf_spec(path_names: Sequence[str], shape: Sequence[int], n: int) -> int | None:
    """The flax-layout dim of a param leaf (`path_names`, ending in the
    module's name and "kernel" or "bias") that tensor parallelism shards
    `n` ways, or None when it does not claim the leaf (JAX's rule)."""
    if n <= 1 or len(path_names) < 2:
        return None
    leaf, module = path_names[-1], path_names[-2]
    role = _ROLES.get(module)
    if role is None:
        return None
    if leaf == "kernel" and len(shape) == 2:
        dim = 1 if role == "col" else 0
        return None if shape[dim] % n else dim
    if leaf == "bias" and len(shape) == 1 and role == "col":
        return None if shape[0] % n else 0
    return None


def tp_dim(name: str, shape: Sequence[int], n: int) -> int | None:
    """The port's dim of the parameter `name` that tensor parallelism
    shards `n` ways, or None."""
    path = name.split(".")
    flax_path = (*path[:-1], "kernel" if path[-1] == "weight" else path[-1])
    return to_port_dim(name, shape, lambda s: tp_leaf_spec(flax_path, s, n))


def attach(model: nn.Module, pls: Mapping[str, Placement]) -> None:
    """Give each Linear whose weight tensor parallelism places its role,
    piece and line; every other Linear of `model` none.  Raises when a
    claimed module is not the port's `nn.layers.Linear`."""
    from ..nn.layers import Linear
    for m in model.modules():
        if isinstance(m, Linear):
            m.tp = None
    for name, pl in pls.items():
        if pl.kind != "tp" or not name.endswith(".weight"):
            continue
        module = model.get_submodule(name.rsplit(".", 1)[0])
        if not isinstance(module, Linear):
            raise TypeError(f"{name}: tensor parallelism claims a {type(module).__name__}, "
                            "not a miseg_tpu_torch.nn.layers.Linear")
        module.tp = ("col" if pl.dim == 0 else "row", pl.index, pl.size, pl.group)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the input as it is; its gradient summed over the line."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the partial products summed over the line; the
    gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceColumns(torch.autograd.Function):
    """Piece `index` of `size` of the last dim of a replicated input; the
    backward all-gathers the pieces' gradients into the full width."""

    @staticmethod
    def forward(ctx, x, index, size, group):
        ctx.size, ctx.group = size, group
        k = x.shape[-1] // size
        return x[..., index * k:(index + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, dim=-1), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def slice_columns(x: torch.Tensor, index: int, size: int, group) -> torch.Tensor:
    return _SliceColumns.apply(x, index, size, group)
