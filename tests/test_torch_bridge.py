"""The JAX -> port weight bridge (`miseg_tpu_torch.weights`), and the
helpers the other `test_torch_*` parity tests share: seeded JAX params
without running flax init, and numpy <-> torch plumbing."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from miseg_tpu.nn.convolutions import conv_transpose
from miseg_tpu.train.pretrained import _flatten, _unflatten
from miseg_tpu_torch.weights import state_dict_from_jax

# Tier-1 runs the suite in several worker processes at once
torch.set_num_threads(1)


def seeded_params(module, *args, seed: int = 0, **kwargs):
    """Params shaped like `module.init(key, *args)["params"]` (via
    `jax.eval_shape`, no eager init) and filled from seeded numpy:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), biases and
    norm shifts ~ N(0, 0.1^2), rel-pos tables ~ N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args, **kwargs)["params"]
    out = {}
    for path, leaf in _flatten(shapes).items():
        shape = tuple(leaf.shape)
        name = path[-1]
        if name == "kernel":
            v = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "relative_position_bias_table":
            v = 0.02 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[path] = v.astype(np.float32)
    return _unflatten(out)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def max_err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def test_layout_rules():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((3, 5)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 1, 4, 6)).astype(np.float32)
    bank = rng.standard_normal((2, 6)).astype(np.float32)
    table = rng.standard_normal((2197, 3)).astype(np.float32)
    tree = {"blk": {"qkv": {"kernel": dense, "bias": bank[0]},
                    "conv1": {"conv": {"kernel": conv}},
                    "norm1": {"scale": bank, "bias": bank},
                    "attn": {"relative_position_bias_table": table}}}
    sd = state_dict_from_jax(tree)
    assert sorted(sd) == sorted([
        "blk.qkv.weight", "blk.qkv.bias", "blk.conv1.conv.weight",
        "blk.norm1.scale", "blk.norm1.bias", "blk.attn.relative_position_bias_table"])
    assert np.array_equal(sd["blk.qkv.weight"].numpy(), dense.T)
    assert np.array_equal(sd["blk.conv1.conv.weight"].numpy(), conv.transpose(4, 3, 0, 1, 2))
    assert np.array_equal(sd["blk.norm1.scale"].numpy(), bank)
    assert np.array_equal(sd["blk.attn.relative_position_bias_table"].numpy(), table)
    assert all(v.is_contiguous() for v in sd.values())


def test_transposed_conv_kernel_matches_lax():
    """lax.conv_transpose does not flip its kernel; torch's does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, 4, 5, 6)).astype(np.float32)
    kernel = rng.standard_normal((2, 3, 2, 6, 4)).astype(np.float32)
    want = conv_transpose(jnp.asarray(x), jnp.asarray(kernel), (2, 2, 2),
                          (0, 0, 0), (0, 0, 0))
    w = state_dict_from_jax({"transp_conv": {"kernel": kernel}})["transp_conv.weight"]
    got = F.conv_transpose3d(t(x).permute(0, 4, 1, 2, 3), w, stride=2)
    assert max_err(got.permute(0, 2, 3, 4, 1), want) <= 1e-5
