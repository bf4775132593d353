"""Bridge the JAX package's parameter tree into the port's `state_dict`.

The port names its modules after the flax paths, so the rename is
mechanical: `a/b/kernel` -> `a.b.weight`, everything else keeps its leaf
name.  Layouts:
  * Dense kernel `[in, out]` -> `[out, in]`;
  * conv kernel `[*k, I, O]` -> `[O, I, *k]`;
  * transposed-conv kernel (a `transp_conv` module) `[*k, I, O]` -> flip
    the spatial axes, then `[I, O, *k]` (lax.conv_transpose does not flip
    the kernel, torch's conv_transpose does);
  * norm `scale`/`bias` (`[C]` or `[S, C]` banks) and
    `relative_position_bias_table` `[T, H]` unchanged.
The result loads with `load_state_dict(..., strict=True)`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_TRANSPOSED = ("transp_conv",)


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def _convert(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    *parent, leaf = path
    if leaf != "kernel":
        return ".".join(path), arr
    name = ".".join([*parent, "weight"])
    if arr.ndim == 2:
        return name, arr.T
    nk = arr.ndim - 2
    spatial = tuple(range(nk))
    if parent and parent[-1] in _TRANSPOSED:
        return name, np.flip(arr, axis=spatial).transpose(nk, nk + 1, *spatial)
    return name, arr.transpose(nk + 1, nk, *spatial)


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """`model.init(...)["params"]` (nested mappings of arrays) -> the port's
    state dict, as CPU tensors of the arrays' dtypes."""
    out = {}
    for path, leaf in _flatten(params):
        name, arr = _convert(path, np.asarray(leaf))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
