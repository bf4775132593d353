"""Fused 3x3x3 conv with normalise-on-read and output statistics — kernel K4.

Replaces the Pallas TPU kernel `_conv_kernel`/`_conv_kernel_plain`
(miseg_tpu/ops/pallas/fused_conv.py:49-93, `_pallas_conv` :96-139)
together with the column fold that follows it (`conv3_norm_stats` :215
then `norm_columns`, fused_norm.py:181).  The CUDA C++ source is
`csrc/fused_conv.cu`; its header says what bounds it on the H100 and how
the design answers.  It is built with nvcc for sm_90a and bound through
ctypes (`build.py`).

`conv3_norm_columns(x, w, scale, shift, slope=..., gamma=..., ...)`:
    t = round(leaky(x * scale + shift))      (f32 math; each part optional)
    y = round(conv3(t))                      zero same-padding of t, stride 1
    (next_scale, next_shift) = the instance-norm columns of y folded with
        gamma/beta (none, `[C]`, or the `[S, C]` bank row of the clamped
        style id), f32 `[B, Cout]`.
The kernel writes per-tile (mean, M2) partials of the rounded y and K1's
fold (`fused_norm.fold_partials`, one more launch) merges them, within the
same call.  In bf16 a tile is a 4x4x16 brick where those divide the volume
(the 96^3 and 48^3 levels, and encoder1's Cin = 1 conv at 96^3, which has
a tensor-core kernel of its own), else a 4x4x4 brick where those do (24^3,
12^3), else the whole sample where it holds at most 256 voxels (6^3, 3^3),
else 128 consecutive voxels; the C side says which.  Calls with few tiles
split K over several CTAs.  The wrapper allocates the f32 workspace for
the split sums, sized by the C side's own plan, and on the coarse path
(the 4x4x4 and whole-sample tiles, whose splits add up inside the one
launch) takes the integer arrival counters of `counters.py`.

For a CUDA tensor the wrapper launches K4 or raises; it uses the plain
version `conv3_norm_columns_plain` only for CPU tensors.  Weights arrive
in the port's `[O, I, 3, 3, 3]` layout; the kernel's `[3, 3, 3, I, O]`
copy is cached on the weight tensor and rebuilt when its version, storage
or the compute dtype changes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import build, counters, fused_norm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # K4 launches since the caller last set it to 0


def _triple(v) -> tuple[int, ...]:
    return tuple(int(i) for i in v) if isinstance(v, (list, tuple)) else (int(v),) * 3


def supported(x_shape, kernel_size, stride) -> bool:
    """The geometry K4 computes: a 5-D channel-last input, kernel 3, stride
    1, every spatial dim >= 2 (fused_conv.py:196-204, without the TPU's
    VMEM estimate)."""
    if len(x_shape) != 5:
        return False
    if _triple(kernel_size) != (3, 3, 3) or _triple(stride) != (1, 1, 1):
        return False
    return all(d >= 2 for d in x_shape[1:4])


def _check(x, w, scale, shift, gamma, beta, styles):
    if x.ndim != 5:
        raise ValueError(f"K4 takes x [B, Z, Y, X, Cin], got {tuple(x.shape)}")
    if w.ndim != 5 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3):
        raise ValueError(f"weights must be [Cout, {x.shape[-1]}, 3, 3, 3], "
                         f"got {tuple(w.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    cols = (x.shape[0], x.shape[-1])
    if scale is not None and (tuple(scale.shape) != cols or tuple(shift.shape) != cols):
        raise ValueError(f"scale/shift must be [B, Cin] = {list(cols)}")
    if gamma is None:
        return
    cout = w.shape[0]
    if (beta is None or gamma.shape != beta.shape or gamma.ndim not in (1, 2)
            or gamma.shape[-1] != cout):
        raise ValueError(f"gamma/beta must both be [Cout] or [S, Cout] with Cout = "
                         f"{cout}, got {tuple(gamma.shape)}, "
                         f"{None if beta is None else tuple(beta.shape)}")
    if gamma.ndim == 2 and (styles is None or tuple(styles.shape) != (x.shape[0],)):
        raise ValueError("conditional banks need a styles vector of length B")


def _transform(x, scale, shift, slope):
    """(f32 pre-activation of the prologue, its result rounded to x's
    dtype): the conv's operand t, in the plain version and recomputed in
    the backward."""
    pre = x.float()
    if scale is not None:
        bshape = (x.shape[0], 1, 1, 1, x.shape[-1])
        pre = pre * scale.float().reshape(bshape) + shift.float().reshape(bshape)
    act = pre if slope is None else torch.where(pre >= 0, pre, slope * pre)
    return pre, act.to(x.dtype)


def conv3_norm_columns_plain(x, w, scale=None, shift=None, *,
                             slope: float | None = None, gamma=None,
                             beta=None, styles=None, eps: float = 1e-5):
    """K4's function in plain PyTorch: the f32 transform rounded to x's
    dtype, `F.conv3d` in f32 on the rounded operands, one rounding of y,
    and two-pass statistics of the rounded y folded with gamma/beta."""
    t = _transform(x, scale, shift, slope)[1].float()
    wf = w.to(x.dtype).float()
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), wf, padding=1)
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()
    sc, sh = fused_norm.channel_scale_shift_plain(
        y.reshape(y.shape[0], -1, y.shape[-1]), gamma, beta, styles, eps=eps)
    return y, sc, sh


@functools.lru_cache(maxsize=None)
def _entry():
    """(C entry point, its split planner, its tile size, its counter count)
    with their ctypes signatures, built on first use."""
    lib = build.load("fused_conv")
    fn = lib.miseg_fused_conv3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    splits = lib.miseg_fused_conv3_splits
    splits.restype = ctypes.c_int
    splits.argtypes = [ctypes.c_int] * 7
    tile = lib.miseg_fused_conv3_tile_voxels
    tile.restype = ctypes.c_int
    tile.argtypes = [ctypes.c_int] * 6
    n_counters = lib.miseg_fused_conv3_counters
    n_counters.restype = ctypes.c_int
    n_counters.argtypes = [ctypes.c_int] * 7
    return fn, splits, tile, n_counters


def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`[O, I, 3, 3, 3]` -> contiguous `[3, 3, 3, I, O]` in `dtype`, cached on
    `w` until its version, storage or the dtype changes."""
    if w.is_inference():  # no version counter: convert per call
        return w.to(dtype).permute(2, 3, 4, 1, 0).contiguous()
    key = (w._version, w.data_ptr(), dtype)
    cached = getattr(w, "_miseg_k4_weights", None)
    if cached is None or cached[0] != key:
        packed = w.detach().to(dtype).permute(2, 3, 4, 1, 0).contiguous()
        cached = (key, packed)
        w._miseg_k4_weights = cached
    return cached[1]


def _conv3_norm_columns(x, w, scale=None, shift=None, *,
                        slope: float | None = None, gamma=None, beta=None,
                        styles=None, eps: float = 1e-5):
    """K4 then K1's fold without autograd (`conv3_norm_columns`)."""
    _check(x, w, scale, shift, gamma, beta, styles)
    if x.device.type == "cpu":
        return conv3_norm_columns_plain(x, w, scale, shift, slope=slope,
                                        gamma=gamma, beta=beta, styles=styles,
                                        eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"K4: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"K4 takes float32 or bfloat16 x, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K4 takes a contiguous, 16-byte aligned x")
    if any(t is not None and t.device != x.device
           for t in (w, scale, shift, gamma, beta, styles)):
        raise ValueError("all operands must be on one device")
    bsz, z, yd, xd, cin = x.shape
    cout = w.shape[0]
    if min(z, yd, xd) < 1:
        raise ValueError(f"K4 takes a non-empty volume, got {tuple(x.shape)}")
    wk = kernel_weights(w, x.dtype)
    if scale is not None:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    fn, plan_splits, tile_voxels, plan_counters = _entry()
    dims = (bsz, z, yd, xd, cin, cout, _DTYPES[x.dtype])
    s = z * yd * xd
    tile = tile_voxels(*dims[1:])
    n_tiles = math.ceil(s / tile)
    y = torch.empty((bsz, z, yd, xd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, bsz * n_tiles, cout), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        splits = plan_splits(*dims)
        work = (torch.empty((splits, bsz * n_tiles * tile, cout), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        ctrs = counters.arrival_counters(x.device, stream, plan_counters(*dims))
        err = fn(x.data_ptr(), wk.data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 shift.data_ptr() if shift is not None else None,
                 float(slope or 0.0), int(slope is not None), y.data_ptr(),
                 part.data_ptr(), work.data_ptr() if work is not None else None,
                 ctrs.data_ptr() if ctrs is not None else None,
                 *dims, stream)
    if err != 0:
        raise RuntimeError(f"fused_conv kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    next_scale, next_shift = fused_norm.fold_partials(
        part, s, tile, n_tiles, gamma, beta, styles, eps=eps)
    return y, next_scale, next_shift


# ------------------------------------------------------------- autograd ----

def conv3_norm_columns_bwd(x, w, scale, shift, y, dy, dscale_next, dshift_next, *,
                           slope=None, gamma=None, beta=None, styles=None,
                           eps: float = 1e-5, needs=(True,) * 6):
    """VJP of `conv3_norm_columns` (of its plain version, following
    `_fconv_bwd` :173 and `norm_columns`): the cotangents of (y,
    next_scale, next_shift), any of them None, -> (dx, dw, dscale, dshift,
    dgamma, dbeta), each None where `needs` (x, w, scale, shift, gamma,
    beta) says no gradient is wanted.

    The columns' cotangent reaches y through K1's fold VJP
    (`fused_norm.channel_scale_shift_bwd` on the saved, rounded y) and is
    added to dy in f32.  The conv's VJP runs in the operand dtype, as
    `_reference` :142 does (cuDNN on the card), on the prologue's result t
    recomputed from x; t's cotangent then goes back through the leaky-relu
    (masked by the sign of the f32 pre-activation) and the affine in f32.
    Where neither x nor the prologue's columns want a gradient (encoder1's
    Cin = 1 conv, whose x is the image), no dx is computed."""
    b, cout = y.shape[0], y.shape[-1]
    dgamma = dbeta = None
    g = torch.zeros(y.shape, dtype=torch.float32, device=y.device) if dy is None else dy.float()
    if dscale_next is not None or dshift_next is not None:
        dys, dgamma, dbeta = fused_norm.channel_scale_shift_bwd(
            y.reshape(b, -1, cout), gamma, beta, styles, dscale_next, dshift_next, eps=eps)
        g = g + dys.reshape(y.shape)
    need_t = needs[0] or (scale is not None and (needs[2] or needs[3]))
    if not (need_t or needs[1]):
        return None, None, None, None, dgamma, dbeta
    prologue = scale is not None or slope is not None
    pre, t = _transform(x, scale, shift, slope) if prologue else (None, x)
    wt = w.to(x.dtype)
    dt, dw, _ = torch.ops.aten.convolution_backward(
        g.to(x.dtype).permute(0, 4, 1, 2, 3), t.permute(0, 4, 1, 2, 3), wt, None,
        [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [need_t, needs[1], False])
    dw = dw.to(w.dtype) if needs[1] else None
    if not need_t:
        return None, dw, None, None, dgamma, dbeta
    dt = dt.permute(0, 2, 3, 4, 1).float()
    if slope is not None:
        dt = torch.where(pre >= 0, dt, slope * dt)
    if scale is None:
        return dt.to(x.dtype), dw, None, None, dgamma, dbeta
    dims = (1, 2, 3)
    bshape = (b, 1, 1, 1, x.shape[-1])
    dx = (dt * scale.float().reshape(bshape)).to(x.dtype) if needs[0] else None
    return (dx, dw, (dt * x.float()).sum(dims).to(scale.dtype), dt.sum(dims).to(shift.dtype),
            dgamma, dbeta)


class _Conv3NormColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, gamma, beta, styles, slope, eps):
        ctx.set_materialize_grads(False)
        y, next_scale, next_shift = _conv3_norm_columns(
            x, w, scale, shift, slope=slope, gamma=gamma, beta=beta, styles=styles, eps=eps)
        ctx.save_for_backward(x, w, scale, shift, y, gamma, beta, styles)
        ctx.slope, ctx.eps = slope, eps
        return y, next_scale, next_shift

    @staticmethod
    def backward(ctx, dy, dscale_next, dshift_next):
        x, w, scale, shift, y, gamma, beta, styles = ctx.saved_tensors
        if dy is None and dscale_next is None and dshift_next is None:
            return (None,) * 9
        grads = conv3_norm_columns_bwd(
            x, w, scale, shift, y, dy, dscale_next, dshift_next, slope=ctx.slope,
            gamma=gamma, beta=beta, styles=styles, eps=ctx.eps,
            needs=ctx.needs_input_grad[:6])
        return (*grads, None, None, None)


def conv3_norm_columns(x, w, scale=None, shift=None, *,
                       slope: float | None = None, gamma=None, beta=None,
                       styles=None, eps: float = 1e-5):
    """K4 then K1's fold: x `[B, Z, Y, X, Cin]`, w `[Cout, Cin, 3, 3, 3]`,
    scale/shift f32 `[B, Cin]` or None, `slope` a leaky-relu after the
    affine.  Returns (y `[B, Z, Y, X, Cout]` in x's dtype, next_scale,
    next_shift f32 `[B, Cout]`) — the counterpart of `conv3_norm_stats`
    followed by `norm_columns`.  Under grad mode it runs inside an
    autograd Function (`conv3_norm_columns_bwd`); the weight's gradient
    comes from that, never from the packed copy of `kernel_weights`."""
    if torch.is_grad_enabled():
        return _Conv3NormColumns.apply(x, w, scale, shift, gamma, beta, styles, slope, eps)
    return _conv3_norm_columns(x, w, scale, shift, slope=slope, gamma=gamma, beta=beta,
                               styles=styles, eps=eps)
