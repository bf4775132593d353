"""Activation registry (counterpart of `miseg_tpu/nn/factories.py:24-87`).

GELU is the exact erf form, as torch's `nn.GELU()` default and the JAX
package (`approximate=False`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

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


def get_act(spec: str | tuple[str, dict[str, Any]] | None):
    """Activation callable for a name or `(name, kwargs)` spec."""
    if spec is None:
        return lambda x: x
    name, kwargs = (spec, {}) if isinstance(spec, str) else spec
    name = name.lower()
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
