"""Parameter initializers driven by an explicit `torch.Generator`
(counterpart of `miseg_tpu/ops/init.py` and flax's `lecun_normal`).

Values are drawn on the CPU from the generator and copied to the
parameter's device, so one seed gives the same weights on every device.
The numbers differ from JAX's for the same seed; tests that compare the
two packages bridge weights with `weights.state_dict_from_jax`.
"""

from __future__ import annotations

import math

import torch

# std of a standard normal truncated to [-2, 2]; flax's variance_scaling
# divides by it so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def trunc_normal(shape, stddev: float, generator: torch.Generator,
                 mean: float = 0.0, lower: float = -2.0,
                 upper: float = 2.0) -> torch.Tensor:
    """f32 CPU tensor, truncated normal (bounds in units of stddev)."""
    u = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(u, 0.0, 1.0, lower, upper, generator=generator)
    return u * stddev + mean


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal`: truncated normal with variance 1/fan_in."""
    return trunc_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


@torch.no_grad()
def fill_(param: torch.Tensor, value: torch.Tensor) -> None:
    param.copy_(value.to(device=param.device, dtype=param.dtype))


@torch.no_grad()
def init_linear(linear: torch.nn.Linear, generator: torch.Generator) -> None:
    """flax `Dense` defaults: lecun-normal kernel, zero bias."""
    fill_(linear.weight, lecun_normal(linear.weight.shape,
                                      linear.in_features, generator))
    if linear.bias is not None:
        linear.bias.zero_()
