"""Bridge the JAX package's parameter tree into the port's `state_dict`.

The port names its modules after the flax paths, so the rename is
mechanical: `a/b/kernel` -> `a.b.weight`, everything else keeps its leaf
name.  Layouts:
  * Dense kernel `[in, out]` -> `[out, in]`;
  * conv kernel `[*k, I, O]` -> `[O, I, *k]`;
  * transposed-conv kernel `[*k, I, O]` -> flip the spatial axes, then
    `[I, O, *k]` (lax.conv_transpose does not flip the kernel, torch's
    conv_transpose does).  A transposed conv is known by its module's
    name (`_is_transposed`): a plain conv's kernel can have the same
    shape, and where I = O nothing else tells them apart;
  * norm `scale`/`bias` (`[C]` or `[S, C]` banks), PReLU `slope` and
    `relative_position_bias_table` `[T, H]` unchanged;
  * the `batch_stats` collection (a batch norm's `mean`/`var`, given
    apart from the params) onto the norm's buffers of the same names.
The result loads with `load_state_dict(..., strict=True)`.

A gradient tree (`jax.grad` of a loss over those params) has the same
paths and layouts, and every rule above is a linear map of the leaf, so
the same function maps JAX's gradients (or Adam moments) onto the port's
parameter names and layouts.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# the modules whose kernel is a transposed conv's: UnetrUpBlock's
# `transp_conv`, UnetrPrUpBlock's `transp_conv_init` and `up0`, `up1`, ...
# (miseg_tpu/nn/unetr_blocks.py:46,71-77), C-UNet's `up`
# (miseg_tpu/models/unet.py:89), and SSLHead's decoder convs, the
# top-level `conv` and `conv_<i>` that hold a kernel themselves
# (miseg_tpu/models/ssl_head.py:60-68; a top-level module is named with a
# leading "/").  `up_path_*` and `up_ru` hold plain convs (under
# `conv`/`residual`), as does every other module, SSLHead's "vae" convs
# included (under `conv_<i>/conv`)
_TRANSPOSED = re.compile(r"/?(transp_conv|transp_conv_init|up\d*)|/conv(_\d+)?")


def _is_transposed(module: str) -> bool:
    return _TRANSPOSED.fullmatch(module) is not None


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def _tensor(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor of its dtype: a tensor as it is (the msgpack
    reader's bf16 leaves), an array copied (bf16 through `uint16`)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _convert(path: tuple[str, ...], leaf: torch.Tensor) -> tuple[str, torch.Tensor]:
    *parent, name = path
    if name != "kernel":
        return ".".join(path), leaf
    weight = ".".join([*parent, "weight"])
    if leaf.ndim == 2:
        return weight, leaf.t()
    nk = leaf.ndim - 2
    spatial = tuple(range(nk))
    if parent and _is_transposed(parent[-1] if len(parent) > 1 else f"/{parent[0]}"):
        return weight, leaf.flip(spatial).permute(nk, nk + 1, *spatial)
    return weight, leaf.permute(nk + 1, nk, *spatial)


def flax_dims(name: str, ndim: int) -> tuple[int, ...]:
    """For the port's tensor `name` of rank `ndim`, the dim of the flax leaf
    each of its dims comes from (`_convert`'s layouts: torch dim j is flax
    dim `flax_dims(...)[j]`): a Linear's `[out, in]` from `[in, out]`, a
    conv's `[O, I, *k]` and a transposed conv's `[I, O, *k]` from
    `[*k, I, O]`; any other leaf keeps its layout."""
    *parent, leaf = name.split(".")
    if leaf != "weight" or ndim < 2:
        return tuple(range(ndim))
    if ndim == 2:
        return (1, 0)
    nk = ndim - 2
    spatial = tuple(range(nk))
    if parent and _is_transposed(parent[-1] if len(parent) > 1 else f"/{parent[0]}"):
        return (nk, nk + 1, *spatial)
    return (nk + 1, nk, *spatial)


def state_dict_from_jax(params: Mapping,
                        batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """`model.init(...)["params"]` (nested mappings of arrays, or of CPU
    tensors as the msgpack reader gives bf16 leaves), or a gradient tree of
    the same paths, and the `batch_stats` collection when the model has
    one -> the port's state dict (or the gradients by parameter name), as
    CPU tensors of the leaves' dtypes."""
    out = {}
    leaves = [*_flatten(params), *_flatten(batch_stats or {})]
    for path, leaf in leaves:
        name, tensor = _convert(path, _tensor(leaf))
        out[name] = tensor.contiguous()
    return out
