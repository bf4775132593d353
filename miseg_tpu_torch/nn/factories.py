"""Activation registry (counterpart of `miseg_tpu/nn/factories.py:24-87`).

GELU is the exact erf form, as torch's `nn.GELU()` default and the JAX
package (`approximate=False`).  `prelu` is a module, `PReLU`, since its
slope is a parameter; every other activation is a plain callable.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.init import fill_

_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "identity": lambda x: x,
}


class PReLU(nn.Module):
    """Parametric ReLU with one learned slope `[1]`, initialised at `init`
    (flax path `.../A/slope`).  Plain PyTorch: K2's fused leaky-relu
    reads its gate from the sign of y, which a learned slope <= 0 breaks
    (miseg_tpu/nn/factories.py:73-79)."""

    def __init__(self, init: float = 0.25, *, device=None, dtype=None):
        super().__init__()
        self.init = float(init)
        self.slope = nn.Parameter(torch.empty((1,), device=device, dtype=dtype))

    def init_parameters(self, generator=None) -> None:
        fill_(self.slope, torch.full((1,), self.init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.slope.to(x.dtype) * x)


def get_act(spec: str | tuple[str, dict[str, Any]] | None, *, device=None, dtype=None):
    """Activation for a name or `(name, kwargs)` spec: a `PReLU` module
    (on `device`, of `dtype`) for `prelu`, else a callable."""
    if spec is None:
        return lambda x: x
    name, kwargs = (spec, {}) if isinstance(spec, str) else spec
    name = name.lower()
    if name == "prelu":
        return PReLU(kwargs.get("init", 0.25), device=device, dtype=dtype)
    if name == "leakyrelu" and kwargs:
        slope = kwargs.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, slope)
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"unknown activation: {name!r}") from None


def leaky_slope(spec: str | tuple[str, dict[str, Any]] | None) -> float | None:
    """negative_slope when `spec` is a leaky-relu with slope > 0, else None
    — the activation then fuses into the preceding norm's K2 pass."""
    if spec is None:
        return None
    name, kwargs = (spec, {}) if isinstance(spec, str) else spec
    if name.lower() != "leakyrelu":
        return None
    slope = float(kwargs.get("negative_slope", 0.01))
    return slope if slope > 0.0 else None
