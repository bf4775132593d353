"""Port K5 (plain version, CPU), `WindowAttention`, and the window / bias
utilities against the JAX package: the Pallas kernel in interpret mode at
atol 1e-5 (f32) or one bf16 ulp of the largest output (bf16), the flax
module on bridged weights at atol 1e-5, and exact equality for the
index/partition utilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.nn.swin import WindowAttention as JWindowAttention
from miseg_tpu.ops import window as JW
from miseg_tpu.ops.pallas import fused_window_attention
from miseg_tpu.ops.rel_bias import rel_pos_index as j_rel_pos_index
from miseg_tpu_torch.nn.swin import WindowAttention
from miseg_tpu_torch.ops import window as TW
from miseg_tpu_torch.ops.kernels.window_attention import window_attention
from miseg_tpu_torch.ops.rel_bias import rel_bias_gather, rel_pos_index
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL = 1e-5


def _ids(dims, window, shift):
    return np.asarray(JW.window_region_ids(dims, window, shift))


# (window batch, N, ids or None, dtype): N=27 from 3^3 windows of a
# shifted 6^3 grid (8 mask windows, batch 2 -> 2*nW), and a clipped N=8
# bias prefix, in f32 and in bf16 (where both round P to bf16 before P.V)
_CASES = {
    "n27_masked_2nw": (16, 27, _ids((6, 6, 6), (3, 3, 3), (1, 1, 1)), "float32"),
    "n27_unmasked": (5, 27, None, "float32"),
    "n8_clipped": (3, 8, None, "float32"),
    "n27_masked_2nw_bf16": (16, 27, _ids((6, 6, 6), (3, 3, 3), (1, 1, 1)), "bfloat16"),
    "n27_unmasked_bf16": (5, 27, None, "bfloat16"),
    "n8_clipped_bf16": (3, 8, None, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_k5_matches_pallas_interpret(rng, case):
    """bf16: q/k/v are the same f32 values rounded to bf16 on both sides;
    the tolerance is one bf16 ulp of the largest output, since both round
    the f32 output once and P's f32 softmax may differ in its last bit."""
    bw, n, ids, dtype = _CASES[case]
    heads, c = 2, 12
    q, k, v = (rng.standard_normal((bw, n, c)).astype(np.float32) for _ in range(3))
    full = rng.standard_normal((heads, 27, 27)).astype(np.float32)
    bias = np.ascontiguousarray(full[:, :n, :n])    # clipped: the [:n, :n] prefix
    jt = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))
    want = fused_window_attention(jt(q), jt(k), jt(v), jnp.asarray(bias),
                                  None if ids is None else jnp.asarray(ids),
                                  num_heads=heads, interpret=True)
    tt = lambda a: t(a).to(getattr(torch, dtype))
    got = window_attention(tt(q), tt(k), tt(v), t(bias),
                           None if ids is None else t(ids), num_heads=heads)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    tol = ATOL if dtype == "float32" else float(np.abs(want).max()) * 2.0 ** -7
    assert max_err(got.float(), want) <= tol


def test_k5_rejects_bad_window_batch(rng):
    ids = t(_ids((6, 6, 6), (3, 3, 3), (1, 1, 1)))     # nW = 8
    q = torch.zeros((12, 27, 12))
    with pytest.raises(ValueError):
        window_attention(q, q, q, torch.zeros((2, 27, 27)), ids, num_heads=2)


@pytest.mark.parametrize("clipped", [False, True])
def test_window_attention_module_matches_flax(rng, clipped):
    """Full 3^3 windows with a shift mask, or n=8 tokens of a 3^3-configured
    window (clipped prefix, no mask)."""
    heads, c, window = 2, 12, (3, 3, 3)
    n = 8 if clipped else 27
    ids = None if clipped else _ids((6, 6, 6), window, (1, 1, 1))
    x = rng.standard_normal((16, n, c)).astype(np.float32)
    jmod = JWindowAttention(num_heads=heads, window_size=window, qkv_bias=True)
    args = (jnp.asarray(x),) + (() if ids is None else (jnp.asarray(ids),))
    params = seeded_params(jmod, *args)
    want = jmod.apply({"params": jax.tree.map(jnp.asarray, params)}, *args)
    port = WindowAttention(c, heads, window, qkv_bias=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(t(x), None if ids is None else t(ids))
    assert max_err(got, want) <= ATOL


@pytest.mark.parametrize("window", [(7, 7, 7), (3, 2, 4), (2, 2, 2)])
def test_rel_pos_index_exact(window):
    assert np.array_equal(rel_pos_index(window), j_rel_pos_index(window))
    table = torch.arange(2 * int(np.prod([2 * w - 1 for w in window]))
                         ).reshape(2, -1)
    bias = rel_bias_gather(table, window).numpy()
    idx = j_rel_pos_index(window)
    assert np.array_equal(bias, table.numpy()[:, idx])


@pytest.mark.parametrize("dims,window,shift", [
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),     # stage 3 at 96^3: 12^3 padded to 14^3
    ((6, 6, 6), (6, 6, 6), (0, 0, 0)),        # stage 4 at 96^3: clipped, unshifted
    ((6, 9, 12), (3, 3, 3), (1, 1, 1)),
])
def test_window_utils_exact(rng, dims, window, shift):
    x = rng.standard_normal((2, *dims, 5)).astype(np.float32)
    parts = TW.window_partition(t(x), window)
    assert np.array_equal(parts.numpy(), np.asarray(JW.window_partition(jnp.asarray(x), window)))
    back = TW.window_reverse(parts, window, (2, *dims))
    assert np.array_equal(back.numpy(), x)
    want = JW.window_region_ids(dims, window, shift)
    got = TW.window_region_ids(dims, window, shift)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    for size in [(12, 12, 12), (3, 12, 7), (6, 6, 6)]:
        assert TW.get_window_size(size, (7, 7, 7), (3, 3, 3)) == \
            JW.get_window_size(size, (7, 7, 7), (3, 3, 3))
