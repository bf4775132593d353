"""Windowed multi-head attention, forward — kernel K5.

Replaces the Pallas TPU kernel `_attn_kernel`/`_attn_kernel_nomask`
(miseg_tpu/ops/pallas/window_attention.py:64-85, `_pallas_forward`
:88-134, public entry `fused_window_attention` :189-207).  The CUDA C++
source is `csrc/window_attention.cu`; its header says what bounds it on
the H100 and how the design answers.  It is built with nvcc for sm_90a
and bound through ctypes (`build.py`).

`window_attention` launches the kernel for a CUDA tensor and uses the
plain version `window_attention_plain` only for a CPU tensor.  In bf16
the kernel runs P.V on the tensor cores, so it rounds the normalised
softmax probabilities to bf16 first, as the Pallas kernel rounds them to
the value dtype (window_attention.py:78); the plain version does the same.
In f32 both keep P in f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..window import ATTN_MASK_VALUE
from . import build

MAX_TOKENS = 343
MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the caller last set it to 0


def window_attention_plain(q, k, v, bias, ids=None, *, num_heads: int):
    """q/k/v `[B*nW, N, C]`; bias `[H, N, N]`; ids `int [nW, N]` or None.
    Returns `[B*nW, N, C]` in q's dtype."""
    bw, n, c = q.shape
    hd = c // num_heads
    qh = q.reshape(bw, n, num_heads, hd).float()
    kh = k.reshape(bw, n, num_heads, hd).float()
    vh = v.reshape(bw, n, num_heads, hd).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * hd ** -0.5
    s = s + bias.float()[None]
    if ids is not None:
        nw = ids.shape[0]
        neq = ids[:, None, :] != ids[:, :, None]                # [nW, N, N]
        s = s.reshape(bw // nw, nw, num_heads, n, n)
        s = torch.where(neq[None, :, None], s + ATTN_MASK_VALUE, s)
        s = s.reshape(bw, num_heads, n, n)
    p = torch.softmax(s, dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.to(q.dtype).float()
    out = torch.einsum("bhnm,bmhd->bnhd", p, vh).reshape(bw, n, c)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    """The library with its ctypes signatures (built on first use)."""
    lib = build.load("window_attention")
    fn = lib.miseg_window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.miseg_window_attention_group.restype = ctypes.c_int
    lib.miseg_window_attention_group.argtypes = [ctypes.c_int] * 3
    return lib


def window_group(bw: int, n: int, num_heads: int, device) -> int:
    """Windows that one CTA of a bf16 call walks on `device`, for tests
    and measurements."""
    with torch.cuda.device(device):
        return int(_lib().miseg_window_attention_group(bw, n, num_heads))


def _check(q, k, v, bias, ids, num_heads):
    bw, n, c = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if c % num_heads:
        raise ValueError(f"{c} channels do not split into {num_heads} heads")
    if bias.shape != (num_heads, n, n):
        raise ValueError(f"bias must be [{num_heads}, {n}, {n}], got {tuple(bias.shape)}")
    if ids is not None:
        if ids.ndim != 2 or ids.shape[1] != n:
            raise ValueError(f"ids must be [nW, {n}], got {tuple(ids.shape)}")
        if bw % ids.shape[0]:
            raise ValueError(f"window batch {bw} is not a multiple of the "
                             f"{ids.shape[0]} mask windows")


def _window_attention(q, k, v, bias, ids=None, *, num_heads: int):
    """K5 without autograd (`window_attention`)."""
    _check(q, k, v, bias, ids, num_heads)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, ids, num_heads=num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    bw, n, c = q.shape
    hd = c // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f"K5 takes N <= {MAX_TOKENS} and head dim <= "
                         f"{MAX_HEAD_DIM}, got N={n}, head dim {hd}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K5 takes float32 or bfloat16 q/k/v, got {q.dtype}")
    if not (q.stride() == k.stride() == v.stride()) or q.stride(2) != 1:
        raise ValueError("q/k/v must share strides with unit channel stride")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError("bias must be a contiguous float32 tensor")
    tensors = [q, k, v, bias] + ([ids] if ids is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if ids is not None and (ids.dtype != torch.int32 or not ids.is_contiguous()):
        raise ValueError("ids must be a contiguous int32 tensor")

    fn = _lib().miseg_window_attention
    out = torch.empty((bw, n, c), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
                 q.stride(1), bias.data_ptr(),
                 ids.data_ptr() if ids is not None else None,
                 ids.shape[0] if ids is not None else 0, out.data_ptr(),
                 bw, n, num_heads, hd, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


# ------------------------------------------------------------- autograd ----

_BWD_CHUNK = 1 << 25   # f32 elements of one [windows, H, N, N] tensor in the backward


def window_attention_bwd(q, k, v, bias, ids, dout, *, num_heads: int):
    """VJP of `window_attention` (`_fwa_bwd` :166): -> (dq, dk, dv in the
    inputs' dtype, dbias f32 `[H, N, N]`).

    P is recomputed in f32 from q, k and the bias, without the bf16
    rounding the forward applies before P.V (ROADMAP W3), as JAX does.
    The windows go in chunks of at most `_BWD_CHUNK` elements a
    `[windows, H, N, N]` tensor (at stage 1 one window's P is 1.4 MB, all
    343 windows' 484 MB), and dbias sums the chunks in order.  The mask
    ids take no gradient."""
    bw, n, c = q.shape
    hd = c // num_heads
    scale = hd ** -0.5
    dq, dk, dv = (torch.empty((bw, n, c), dtype=t.dtype, device=t.device) for t in (q, k, v))
    dbias = torch.zeros((num_heads, n, n), dtype=torch.float32, device=q.device)
    step = max(1, _BWD_CHUNK // (num_heads * n * n))
    for b0 in range(0, bw, step):
        b1 = min(bw, b0 + step)
        qh, kh, vh, doh = (t[b0:b1].reshape(b1 - b0, n, num_heads, hd).float()
                           for t in (q, k, v, dout))
        s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * scale + bias.float()[None]
        if ids is not None:
            win = ids[torch.arange(b0, b1, device=ids.device) % ids.shape[0]]
            neq = win[:, None, :] != win[:, :, None]                # [b, N, N]
            s = torch.where(neq[:, None], s + ATTN_MASK_VALUE, s)
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bnhd,bmhd->bhnm", doh, vh)
        dv[b0:b1] = torch.einsum("bhnm,bnhd->bmhd", p, doh).reshape(b1 - b0, n, c)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))          # softmax VJP
        dq[b0:b1] = torch.einsum("bhnm,bmhd->bnhd", ds, kh).reshape(b1 - b0, n, c) * scale
        dk[b0:b1] = torch.einsum("bhnm,bnhd->bmhd", ds, qh).reshape(b1 - b0, n, c) * scale
        dbias += ds.sum(0)
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, ids, num_heads):
        ctx.save_for_backward(q, k, v, bias, ids)
        ctx.num_heads = num_heads
        return _window_attention(q, k, v, bias, ids, num_heads=num_heads)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, ids = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, ids, dout,
                                                 num_heads=ctx.num_heads)
        return dq, dk, dv, dbias.to(bias.dtype), None, None


def window_attention(q, k, v, bias, ids=None, *, num_heads: int):
    """Fused windowed MHSA; same contract as `window_attention_plain`.

    On a CUDA tensor this launches K5 or raises.  q/k/v may be strided
    views (e.g. slices of one qkv projection) as long as they share
    strides and the channel stride is 1; under grad mode each view takes
    its own gradient (`window_attention_bwd`) and autograd assembles the
    projection's."""
    if torch.is_grad_enabled():
        return _WindowAttention.apply(q, k, v, bias, ids, num_heads)
    return _window_attention(q, k, v, bias, ids, num_heads=num_heads)
