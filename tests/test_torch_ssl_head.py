"""The port's SSLHead (`miseg_tpu_torch.models.SSLHead`) against the JAX
package's on the CPU: the same seeded weights carried over by
`weights.state_dict_from_jax`, the same input, all three decoders, f32.

Model: feature_size 12 (bottom stage 192 channels), `dim` 192 (the vae
decoder's widths 96, 48, 24, 12, 12), a 64x32x32 input, whose bottom
stage holds the 2 tokens the two heads read.  The outputs agree at atol
2e-4, the model tests' bound.  The x2 trilinear upsample is held alone
against `jax.image.resize(method="linear")`, borders included, at atol
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.models.ssl_head import SSLHead as JSSLHead
from miseg_tpu.models.ssl_head import _trilinear_upsample
from miseg_tpu_torch.models import SSLHead
from miseg_tpu_torch.models.ssl_head import trilinear_upsample
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL = 2e-4
SHAPE = (1, 64, 32, 32, 1)


@pytest.mark.parametrize("shape", [(2, 3, 5, 4, 3), (1, 1, 2, 7, 2)])
def test_trilinear_upsample_matches_jax_resize(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = _trilinear_upsample(jnp.asarray(x), 2)
    got = trilinear_upsample(t(x), 2)
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-6


@pytest.mark.parametrize("upsample", ["vae", "deconv", "large_kernel_deconv"])
def test_ssl_head_matches_jax(upsample):
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    jmodel = JSSLHead(feature_size=12, upsample=upsample, dim=192)
    params = seeded_params(jmodel, jnp.zeros(SHAPE))
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, jnp.asarray(x))

    model = SSLHead(feature_size=12, upsample=upsample, dim=192, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model(t(x))
    names = ("rotation", "contrastive", "reconstruction")
    assert [tuple(g.shape) for g in got] == [(1, 4), (1, 512), SHAPE]
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert max_err(g, w) <= ATOL, f"{upsample} {name}: {max_err(g, w):.2e}"


def test_bridge_names_only_sslhead_decoders_transposed_at_top_level():
    """The bridge's top-level rule (`/conv`, `/conv_<i>`) holds a kernel
    only in SSLHead's transposed decoders; its vae convs stay plain."""
    from miseg_tpu_torch.weights import _is_transposed

    assert _is_transposed("/conv") and _is_transposed("/conv_3")
    assert not _is_transposed("conv") and not _is_transposed("conv_3")
    assert not _is_transposed("/conv_out") and not _is_transposed("/rotation_head")
    vae = SSLHead(feature_size=12, dim=192, device="meta").state_dict()
    assert "conv_0.conv.weight" in vae and "conv_0.weight" not in vae
