"""Normalization module with optional modality conditioning (counterpart
of `miseg_tpu/nn/norms.py:27-120`).

`instance` and `instance_cond` run through K1 then K2
(`ops.kernels.fused_norm`) on every call, with the trailing residual add
and leaky-relu fused into K2.  `layer`, `group` and `batch` are plain
PyTorch (the JAX package has no kernel for them), followed by JAX's tail:
`y (+ add)`, then the leaky-relu.  Parameters are `scale`/`bias` as in
flax: `[C]`, or `[num_styles, C]` banks for `instance_cond`.

`batch` keeps its running statistics in the f32 buffers `mean` and `var`
(flax's `batch_stats` collection), whatever the parameters' dtype.  In
training mode it normalises with the batch's statistics and updates the
buffers, detached, as `0.9 * old + 0.1 * new` on every call; in eval
mode it normalises with the buffers.  Under data parallelism the
batch's statistics are the global batch's (`parallel.batch_stats`, as
JAX's on its global array), so the running statistics stay equal on
every rank.

Under spatial partitioning (`parallel/spatial.py`) a norm of a D slab
takes the whole volume's statistics: the instance kinds through K1's
moments mode, the line's merge and K2 on the merged columns
(`spatial.instance_norm_act`), `group` merged per group
(`spatial.group_norm`), `batch` over the data x spatial ranks
(`parallel.batch_stats`); `layer` is per token and stays local.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .. import parallel
from ..ops import norms as N
from ..ops.init import fill_
from ..parallel import spatial

KINDS = ("instance_cond", "instance", "layer", "group", "batch")
MOMENTUM = 0.9   # batch norm's running-statistics decay (miseg_tpu/nn/norms.py:38)
RUNNING_STATS = ("mean", "var")   # batch norm's buffers (flax's `batch_stats`)


class Norm(nn.Module):
    def __init__(self, kind: str, features: int, num_styles: int = 2,
                 affine: bool = True, num_groups: int = 8, eps: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown norm kind: {kind!r}")
        self.kind, self.features, self.eps = kind, features, eps
        self.num_groups = num_groups
        shape = None
        if kind == "instance_cond":  # always affine (reference ignores affine=False)
            shape = (num_styles, features)
        elif affine:
            shape = (features,)
        if shape is None:
            self.scale = self.bias = None
        else:
            self.scale = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
            self.bias = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        if kind == "batch":
            for name in RUNNING_STATS:
                self.register_buffer(name, torch.empty(features, device=device,
                                                       dtype=torch.float32))

    def init_parameters(self, generator=None) -> None:
        if self.scale is not None:
            fill_(self.scale, torch.ones(self.scale.shape))
            fill_(self.bias, torch.zeros(self.bias.shape))
        if self.kind == "batch":
            fill_(self.mean, torch.zeros(self.features))
            fill_(self.var, torch.ones(self.features))

    def forward(self, x, modalities=None, *, act_slope: float | None = None,
                add=None):
        """`act_slope`/`add` apply a trailing `y (+ add) -> leaky_relu`,
        fused into K2 for the instance kinds."""
        if x.shape[-1] != self.features:
            raise ValueError(f"Norm expected {self.features} channels, got {x.shape[-1]}")
        if self.kind in ("instance", "instance_cond"):
            if self.kind == "instance_cond" and modalities is None:
                raise ValueError("instance_cond norm requires a `modalities` vector")
            styles = modalities if self.kind == "instance_cond" else None
            return spatial.instance_norm_act(
                x, self.scale, self.bias, styles, eps=self.eps,
                negative_slope=act_slope, add=add)
        if self.kind == "layer":
            y = N.layer_norm(x, self.scale, self.bias, eps=self.eps)
        elif self.kind == "group":
            group_norm = spatial.group_norm if spatial.line_of(x) is not None else N.group_norm
            y = group_norm(x, self.num_groups, self.scale, self.bias, eps=self.eps)
        else:
            y = self._batch_norm(x)
        if add is not None:
            y = y + add
        if act_slope is not None:
            y = torch.where(y >= 0, y, act_slope * y)
        return y

    def _batch_norm(self, x):
        if not self.training:
            return N.batch_norm_inference(x, self.mean, self.var, self.scale, self.bias,
                                          eps=self.eps)
        mean, var = parallel.batch_stats(x)
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        return N.batch_norm_inference(x, mean, var, self.scale, self.bias, eps=self.eps)


def make_norm(spec: tuple[str, dict[str, Any]] | str | None, features: int,
              *, device=None, dtype=None) -> Norm | None:
    """A `Norm` from a `(name, kwargs)` spec (or bare name)."""
    if spec is None:
        return None
    kind, kwargs = (spec, {}) if isinstance(spec, str) else spec
    kw = dict(kwargs)
    affine = kw.pop("affine", kw.pop("elementwise_affine", True))
    return Norm(kind, features, num_styles=kw.pop("num_styles", 2), affine=affine,
                num_groups=kw.pop("num_groups", 8), eps=kw.pop("eps", 1e-5),
                device=device, dtype=dtype)
