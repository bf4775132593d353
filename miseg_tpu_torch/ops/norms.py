"""Functional normalization ops (channel-last), counterpart of
`miseg_tpu/ops/norms.py`.

Statistics are f32 with TWO-PASS variance, `E[(x - mean)^2]`
(ops/norms.py:130-139): the one-pass `E[x^2] - mean^2` form loses digits
whenever var << mean^2.  The norm is computed explicitly rather than with
`F.instance_norm`, whose CPU kernel mishandles non-contiguous views in
torch 2.13.

These are the plain references.  The model's instance norms run through
`ops.kernels.fused_norm` (kernels K1 + K2 on the card); layer, group and
batch norms run these functions (the JAX package has no kernel for them).
Batch statistics alone use the one-pass variance, clamped at 0, as the
JAX package's `batch_stats` does (ops/norms.py:220-225).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def stats(x: Tensor, dims: tuple[int, ...], eps: float) -> tuple[Tensor, Tensor]:
    """f32 (mean, inv_std) over `dims`, kept for broadcasting."""
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    return mean, torch.rsqrt(var.clamp_min(0.0) + eps)


def _spatial_dims(x: Tensor) -> tuple[int, ...]:
    return tuple(range(1, x.ndim - 1))


def instance_norm(x: Tensor, gamma: Tensor | None = None,
                  beta: Tensor | None = None, *, eps: float = 1e-5) -> Tensor:
    """Instance norm over the spatial dims of `[B, *spatial, C]`;
    gamma/beta `[C]` or None (parameter-free)."""
    mean, inv = stats(x, _spatial_dims(x), eps)
    y = (x.float() - mean) * inv
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def conditional_instance_norm(x: Tensor, styles: Tensor, gamma: Tensor,
                              beta: Tensor, *, eps: float = 1e-5) -> Tensor:
    """Per-sample bank `[S, C]` selected by `styles: int[B]`; out-of-range
    ids clamp to the nearest bank (ops/norms.py:170-175)."""
    idx = styles.long().clamp(0, gamma.shape[0] - 1)
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    mean, inv = stats(x, _spatial_dims(x), eps)
    y = (x.float() - mean) * inv
    y = y * gamma.float()[idx].reshape(bshape) + beta.float()[idx].reshape(bshape)
    return y.to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor | None = None,
               beta: Tensor | None = None, *, eps: float = 1e-5) -> Tensor:
    """Layer norm over the trailing channel axis."""
    mean, inv = stats(x, (-1,), eps)
    y = (x.float() - mean) * inv
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def group_norm(x: Tensor, num_groups: int, gamma: Tensor | None = None,
               beta: Tensor | None = None, *, eps: float = 1e-5) -> Tensor:
    """Group norm over `[B, *spatial, C]` with C split into `num_groups`
    (two-pass statistics over the spatial dims and the group's channels)."""
    b, *spatial, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    xg = x.reshape(b, *spatial, num_groups, c // num_groups)
    mean, inv = stats(xg, tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,), eps)
    y = ((xg.float() - mean) * inv).reshape(x.shape)
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def batch_stats(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-channel f32 (mean, var) `[C]` over the batch and spatial dims of
    `[B, *spatial, C]`: the ONE-PASS `E[x^2] - mean^2`, clamped at 0."""
    dims = tuple(range(x.ndim - 1))
    x32 = x.float()
    mean = x32.mean(dim=dims)
    var = x32.square().mean(dim=dims) - mean.square()
    return mean, var.clamp_min(0.0)


def batch_norm_inference(x: Tensor, mean: Tensor, var: Tensor, gamma: Tensor | None,
                         beta: Tensor | None, *, eps: float = 1e-5) -> Tensor:
    """Batch norm of `[B, *spatial, C]` with the given statistics `[C]`."""
    inv = torch.rsqrt(var.float() + eps)
    y = (x.float() - mean.float()) * inv
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def parse_normalization(norm_name: str, *, num_styles: int = 2,
                        affine: bool = True, num_groups: int = 8):
    """CLI string -> (name, kwargs) norm spec (ops/norms.py:228-244)."""
    if norm_name == "instance_cond":
        return (norm_name, {"num_styles": num_styles, "affine": affine})
    if norm_name in ("instance", "batch"):
        return (norm_name, {"affine": affine})
    if norm_name == "layer":
        return (norm_name, {"elementwise_affine": affine})
    if norm_name == "group":
        return (norm_name, {"affine": affine, "num_groups": num_groups})
    return (norm_name, {})
