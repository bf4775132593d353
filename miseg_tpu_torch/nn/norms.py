"""Normalization module with optional modality conditioning (counterpart
of `miseg_tpu/nn/norms.py:27-120`).

`instance` and `instance_cond` run through K1 then K2
(`ops.kernels.fused_norm`) on every call, with the trailing residual add
and leaky-relu fused into K2.  `layer` is plain PyTorch (the JAX package
has no kernel for it).  Parameters are `scale`/`bias` as in flax: `[C]`,
or `[num_styles, C]` banks for `instance_cond`.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..ops import norms as N
from ..ops.init import fill_
from ..ops.kernels import fused_norm


class Norm(nn.Module):
    def __init__(self, kind: str, features: int, num_styles: int = 2,
                 affine: bool = True, eps: float = 1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        if kind not in ("instance_cond", "instance", "layer"):
            raise ValueError(f"unsupported norm kind in the port: {kind!r}")
        self.kind, self.features, self.eps = kind, features, eps
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

    def init_parameters(self, generator=None) -> None:
        if self.scale is not None:
            fill_(self.scale, torch.ones(self.scale.shape))
            fill_(self.bias, torch.zeros(self.bias.shape))

    def forward(self, x, modalities=None, *, act_slope: float | None = None,
                add=None):
        """`act_slope`/`add` fuse a trailing `y (+ add) -> leaky_relu`
        (instance kinds only)."""
        if x.shape[-1] != self.features:
            raise ValueError(f"Norm expected {self.features} channels, got {x.shape[-1]}")
        if self.kind == "layer":
            if act_slope is not None or add is not None:
                raise ValueError("layer norm takes no fused act/add tail")
            return N.layer_norm(x, self.scale, self.bias, eps=self.eps)
        if self.kind == "instance_cond" and modalities is None:
            raise ValueError("instance_cond norm requires a `modalities` vector")
        styles = modalities if self.kind == "instance_cond" else None
        return fused_norm.instance_norm_act(
            x, self.scale, self.bias, styles, eps=self.eps,
            negative_slope=act_slope, add=add)


def make_norm(spec: tuple[str, dict[str, Any]] | str | None, features: int,
              *, device=None, dtype=None) -> Norm | None:
    """A `Norm` from a `(name, kwargs)` spec (or bare name)."""
    if spec is None:
        return None
    kind, kwargs = (spec, {}) if isinstance(spec, str) else spec
    kw = dict(kwargs)
    affine = kw.pop("affine", kw.pop("elementwise_affine", True))
    return Norm(kind, features, num_styles=kw.pop("num_styles", 2),
                affine=affine, eps=kw.pop("eps", 1e-5), device=device,
                dtype=dtype)
