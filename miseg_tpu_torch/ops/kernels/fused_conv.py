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
same call.  bf16 calls whose Cin and Cout are multiples of 4 (or Cin = 1)
run on the tensor cores, channels that are no multiple of 16 (the search
space's 12, 24, 36, 72) padded to 16 inside the kernel.  Their tile is a
4x4x16 brick where those divide the volume (the 96^3 and 48^3 levels, and
encoder1's Cin = 1 conv at 96^3, which has a tensor-core kernel of its
own), else a 4x4x4 brick where those do (24^3, 12^3), else the whole
sample where it holds at most 256 voxels (6^3, 3^3).  Every other call
(f32, other bf16 widths, larger volumes no brick divides) runs on the CUDA
cores in tiles of 128 consecutive voxels.  The C side plans each call and
says which.  Calls with few tiles split K over several CTAs.  The wrapper
allocates the f32 workspace for the split sums, sized by the C side's own
plan, and on the coarse path (the 4x4x4 and whole-sample tiles, whose
splits add up inside the one launch) takes the integer arrival counters
of `counters.py`.

For a CUDA tensor the wrapper launches K4 or raises; it uses the plain
version `conv3_norm_columns_plain` only for CPU tensors.  Weights arrive
in the port's `[O, I, 3, 3, 3]` layout; the kernel's `[3, 3, 3, I', O']`
copy (I' >= I and O' >= O the widths the C side plans: zero rows and
columns for the padded channels) is cached on the weight tensor and
rebuilt when its version, storage, the compute dtype or the widths change.
K4 with its fold is also the registered op `miseg::conv3_norm_columns`,
which the wrapper calls while tracing (section "registered op").

K4's D-halo mode (`conv3_halo_moments`, spatial partitioning,
`parallel/spatial.py`): x is a rank's D slab with one plane of each
neighbour around it, `[B, Dl + 2, H, W, Cin]`, two flags say whether the
low and high planes are the volume's own zero padding (zero after the
prologue, as today's same-padding is), and y is `[B, Dl, H, W, Cout]`.
The same kernels run it (their C planners plan on the output's
geometry), and the fold runs in its moments mode: the call returns the
slab's per-(sample, channel) f32 (mean, M2) for the line's merge in place
of the columns.  Its launches count in `halo_launches`; it is the
registered op `miseg::conv3_halo_moments`.
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
halo_launches = 0  # K4 launches in D-halo mode since the caller last set it to 0


def _triple(v) -> tuple[int, ...]:
    return tuple(int(i) for i in v) if isinstance(v, (list, tuple)) else (int(v),) * 3


def supported(x_shape, kernel_size, stride, halo: bool = False) -> bool:
    """The geometry K4 computes: a 5-D channel-last input, kernel 3, stride
    1, every spatial dim >= 2 (fused_conv.py:196-204, without the TPU's
    VMEM estimate); in D-halo mode `x_shape` is the halo'd slab's, whose
    own planes (D - 2) need only be one or more."""
    if len(x_shape) != 5:
        return False
    if _triple(kernel_size) != (3, 3, 3) or _triple(stride) != (1, 1, 1):
        return False
    return x_shape[1] >= (3 if halo else 2) and all(d >= 2 for d in x_shape[2:4])


def _check(x, w, scale, shift, gamma, beta, styles, halo: bool = False):
    if x.ndim != 5 or (halo and x.shape[1] < 3):
        raise ValueError(f"K4 takes x [B, Z{' + 2' * halo}, Y, X, Cin], got {tuple(x.shape)}")
    if halo and gamma is not None:
        raise ValueError("K4's D-halo mode returns moments: it takes no gamma/beta")
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


def _transform(x, scale, shift, slope, pads=(False, False)):
    """(f32 pre-activation of the prologue, its result rounded to x's
    dtype): the conv's operand t, in the plain version and recomputed in
    the backward.  `pads` (D-halo mode): whether x's first and last planes
    are the volume's padding, zero in t."""
    pre = x.float()
    if scale is not None:
        bshape = (x.shape[0], 1, 1, 1, x.shape[-1])
        pre = pre * scale.float().reshape(bshape) + shift.float().reshape(bshape)
    act = pre if slope is None else torch.where(pre >= 0, pre, slope * pre)
    return pre, _zero_pads(act.to(x.dtype), pads)


def _zero_pads(t, pads):
    """`t` with its first (pads[0]) and last (pads[1]) D planes zeroed."""
    if not any(pads):
        return t
    keep = torch.ones(t.shape[1], dtype=t.dtype, device=t.device)
    keep[0], keep[-1] = (0 if pads[0] else 1), (0 if pads[1] else 1)
    return t * keep.reshape(1, -1, 1, 1, 1)


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


def conv3_halo_moments_plain(x, w, scale=None, shift=None, *, slope: float | None = None,
                             pad_lo: bool = False, pad_hi: bool = False):
    """K4's D-halo mode in plain PyTorch: x `[B, Dl + 2, H, W, Cin]` ->
    (y `[B, Dl, H, W, Cout]`, each sample's f32 (mean, M2) `[B, Cout]` of
    the rounded y): the f32 transform rounded to x's dtype with the flagged
    planes zero, `F.conv3d` in f32 without D padding, one rounding of y,
    two-pass moments."""
    t = _transform(x, scale, shift, slope, (pad_lo, pad_hi))[1].float()
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), w.to(x.dtype).float(), padding=(0, 1, 1))
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()
    return (y, *fused_norm.channel_moments_plain(y.reshape(y.shape[0], -1, y.shape[-1])))


@functools.lru_cache(maxsize=None)
def _entry():
    """(C entry point, its split planner, its tile size, its counter count,
    its packed weights' widths) with their ctypes signatures, built on
    first use."""
    lib = build.load("fused_conv")
    fn = lib.miseg_fused_conv3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    splits = lib.miseg_fused_conv3_splits
    splits.restype = ctypes.c_int
    splits.argtypes = [ctypes.c_int] * 7
    tile = lib.miseg_fused_conv3_tile_voxels
    tile.restype = ctypes.c_int
    tile.argtypes = [ctypes.c_int] * 6
    n_counters = lib.miseg_fused_conv3_counters
    n_counters.restype = ctypes.c_int
    n_counters.argtypes = [ctypes.c_int] * 7
    widths = lib.miseg_fused_conv3_weight_widths
    widths.restype = None
    widths.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    return fn, splits, tile, n_counters, widths


@functools.lru_cache(maxsize=None)
def weight_widths(z: int, y: int, x: int, cin: int, cout: int, dtype: int) -> tuple[int, int]:
    """(I', O'): the widths of the packed weights a call of this shape
    takes (`dtype` 0 f32, 1 bf16), from the C side's plan."""
    out = (ctypes.c_int * 2)()
    _entry()[4](z, y, x, cin, cout, dtype, out)
    return out[0], out[1]


def _pack(w: torch.Tensor, dtype: torch.dtype, widths: tuple[int, int]) -> torch.Tensor:
    packed = w.detach().to(dtype).permute(2, 3, 4, 1, 0)
    cout, cin = w.shape[:2]
    if widths != (cin, cout):
        packed = F.pad(packed, (0, widths[1] - cout, 0, widths[0] - cin))
    return packed.contiguous()


def kernel_weights(w: torch.Tensor, dtype: torch.dtype,
                   widths: tuple[int, int] | None = None) -> torch.Tensor:
    """`[O, I, 3, 3, 3]` -> contiguous `[3, 3, 3, I', O']` in `dtype`, with
    `widths` (I', O') >= (I, O) (default (I, O)): rows ci >= I and columns
    co >= O are zero.  Cached on `w`, one copy, until its version, storage,
    the dtype or the widths change."""
    widths = (w.shape[1], w.shape[0]) if widths is None else tuple(widths)
    if w.is_inference():  # no version counter: convert per call
        return _pack(w, dtype, widths)
    key = (w._version, w.data_ptr(), dtype, widths)
    cached = getattr(w, "_miseg_k4_weights", None)
    if cached is None or cached[0] != key:
        cached = (key, _pack(w, dtype, widths))
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
    y, cols = _conv_launch(x, w, scale, shift, slope, gamma, beta, styles, eps)
    return y, cols[0], cols[1]


def _conv_launch(x, w, scale, shift, slope, gamma, beta, styles, eps, halo: int = 0):
    """One K4 launch and its fold over a CUDA x: (y, f32 (next_scale,
    next_shift) stacked `[2, B, Cout]`).  `halo` (D-halo mode): 1, plus 2
    when x's first plane is the volume's padding and 4 when its last is;
    then y has two planes fewer than x and the fold gives (mean, M2)."""
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
    z -= 2 * (halo & 1)
    cout = w.shape[0]
    if min(z, yd, xd) < 1:
        raise ValueError(f"K4 takes a non-empty volume, got {tuple(x.shape)}")
    dims = (bsz, z, yd, xd, cin, cout, _DTYPES[x.dtype])
    widths = weight_widths(*dims[1:])
    wk = kernel_weights(w, x.dtype, widths)
    if scale is not None:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    fn, plan_splits, tile_voxels, plan_counters, _ = _entry()
    s = z * yd * xd
    tile = tile_voxels(*dims[1:])
    n_tiles = math.ceil(s / tile)
    y = torch.empty((bsz, z, yd, xd, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, bsz * n_tiles, cout), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        splits = plan_splits(*dims)
        work = (torch.empty((splits, bsz * n_tiles * tile, widths[1]), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        ctrs = counters.arrival_counters(x.device, stream, plan_counters(*dims))
        err = fn(x.data_ptr(), wk.data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 shift.data_ptr() if shift is not None else None,
                 float(slope or 0.0), int(slope is not None), y.data_ptr(),
                 part.data_ptr(), work.data_ptr() if work is not None else None,
                 ctrs.data_ptr() if ctrs is not None else None,
                 *dims, halo, stream)
    if err != 0:
        raise RuntimeError(f"fused_conv kernel launch failed: CUDA error {err}")
    global launches, halo_launches
    if halo:
        halo_launches += 1
    else:
        launches += 1
    cols = fused_norm.fold_launch(part, s, tile, n_tiles, gamma, beta, styles, eps=eps,
                                  moments=bool(halo))
    return y, cols


def _halo_flags(pad_lo: bool, pad_hi: bool) -> int:
    return 1 | 2 * bool(pad_lo) | 4 * bool(pad_hi)


def _conv3_halo_moments(x, w, scale=None, shift=None, *, slope=None, pad_lo=False,
                        pad_hi=False):
    """K4's D-halo mode then the fold's moments mode without autograd
    (`conv3_halo_moments`)."""
    _check(x, w, scale, shift, None, None, None, halo=True)
    if x.device.type == "cpu":
        return conv3_halo_moments_plain(x, w, scale, shift, slope=slope, pad_lo=pad_lo,
                                        pad_hi=pad_hi)
    y, mom = _conv_launch(x, w, scale, shift, slope, None, None, None, 1e-5,
                          _halo_flags(pad_lo, pad_hi))
    return y, mom[0], mom[1]


# ------------------------------------------------------- registered op ----
#
# K4 with its fold as the `torch.library` op `miseg::conv3_norm_columns`:
# a fake (shapes and dtypes only), a "cpu" kernel (the plain version) and
# a "cuda" kernel (K4 and one `miseg_k1_fold` launch).  The wrapper calls
# it only while tracing (see `fused_norm`'s registered ops); the columns
# come stacked `[2, B, Cout]`, one fresh tensor.

@torch.library.custom_op("miseg::conv3_norm_columns", mutates_args=())
def conv3_norm_columns_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                          shift: torch.Tensor | None, gamma: torch.Tensor | None,
                          beta: torch.Tensor | None, styles: torch.Tensor | None,
                          slope: float | None, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 + K1's fold: (y in x's dtype, f32 (next_scale, next_shift)
    stacked `[2, B, Cout]`)."""
    raise ValueError(f"miseg::conv3_norm_columns: unsupported device {x.device}")


@conv3_norm_columns_op.register_kernel("cpu")
def _(x, w, scale, shift, gamma, beta, styles, slope, eps):
    y, sc, sh = _conv3_norm_columns(x, w, scale, shift, slope=slope, gamma=gamma, beta=beta,
                                    styles=styles, eps=eps)
    return y, torch.stack((sc, sh))


@conv3_norm_columns_op.register_kernel("cuda")
def _(x, w, scale, shift, gamma, beta, styles, slope, eps):
    _check(x, w, scale, shift, gamma, beta, styles)
    return _conv_launch(x, w, scale, shift, slope, gamma, beta, styles, eps)


@conv3_norm_columns_op.register_fake
def _(x, w, scale, shift, gamma, beta, styles, slope, eps):
    _check(x, w, scale, shift, gamma, beta, styles)
    y = x.new_empty((*x.shape[:-1], w.shape[0]))
    return y, x.new_empty((2, x.shape[0], w.shape[0]), dtype=torch.float32)


@torch.library.custom_op("miseg::conv3_halo_moments", mutates_args=())
def conv3_halo_moments_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                          shift: torch.Tensor | None, slope: float | None, pad_lo: bool,
                          pad_hi: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's D-halo mode + the fold's moments mode: (y in x's dtype with two
    planes fewer than x, f32 (mean, M2) stacked `[2, B, Cout]`)."""
    raise ValueError(f"miseg::conv3_halo_moments: unsupported device {x.device}")


@conv3_halo_moments_op.register_kernel("cpu")
def _(x, w, scale, shift, slope, pad_lo, pad_hi):
    y, mean, m2 = _conv3_halo_moments(x, w, scale, shift, slope=slope, pad_lo=pad_lo,
                                      pad_hi=pad_hi)
    return y, torch.stack((mean, m2))


@conv3_halo_moments_op.register_kernel("cuda")
def _(x, w, scale, shift, slope, pad_lo, pad_hi):
    _check(x, w, scale, shift, None, None, None, halo=True)
    return _conv_launch(x, w, scale, shift, slope, None, None, None, 1e-5,
                        _halo_flags(pad_lo, pad_hi))


@conv3_halo_moments_op.register_fake
def _(x, w, scale, shift, slope, pad_lo, pad_hi):
    _check(x, w, scale, shift, None, None, None, halo=True)
    y = x.new_empty((x.shape[0], x.shape[1] - 2, *x.shape[2:-1], w.shape[0]))
    return y, x.new_empty((2, x.shape[0], w.shape[0]), dtype=torch.float32)


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
    comes from that, never from the packed copy of `kernel_weights`.
    While tracing it calls the op `miseg::conv3_norm_columns`."""
    if torch.compiler.is_compiling():
        y, cols = torch.ops.miseg.conv3_norm_columns(x, w, scale, shift, gamma, beta, styles,
                                                     slope, eps)
        return y, cols[0], cols[1]
    if torch.is_grad_enabled():
        return _Conv3NormColumns.apply(x, w, scale, shift, gamma, beta, styles, slope, eps)
    return _conv3_norm_columns(x, w, scale, shift, slope=slope, gamma=gamma, beta=beta,
                               styles=styles, eps=eps)


def conv3_halo_moments_bwd(x, w, scale, shift, y, mean, dy, dmean, dm2, *, slope=None,
                           pad_lo=False, pad_hi=False, needs=(True,) * 4):
    """VJP of `conv3_halo_moments`: the cotangents of (y, mean, M2), any
    of them None, -> (dx over all Dl + 2 planes, dw, dscale, dshift), each
    None where `needs` (x, w, scale, shift) says no gradient is wanted.

    The moments' cotangent reaches y as `dmean / S + 2 (y - mean) dM2`
    and is added to dy in f32; the conv's VJP runs in the operand dtype on
    the prologue's result t recomputed from x (the flagged planes zero),
    without D padding; t's cotangent is zero on the flagged planes, then
    goes back through the leaky-relu and the affine in f32, so dscale and
    dshift sum over every plane this rank read, its neighbours' halo
    planes included (their sum over the line is the whole gradient)."""
    b, cout = y.shape[0], y.shape[-1]
    g = torch.zeros(y.shape, dtype=torch.float32, device=y.device) if dy is None else dy.float()
    if dmean is not None or dm2 is not None:
        y3 = y.reshape(b, -1, cout)
        g = g + fused_norm.channel_moments_bwd(y3, mean, dmean, dm2).reshape(y.shape)
    need_t = needs[0] or (scale is not None and (needs[2] or needs[3]))
    if not (need_t or needs[1]):
        return None, None, None, None
    pads = (pad_lo, pad_hi)
    prologue = scale is not None or slope is not None
    pre, t = (_transform(x, scale, shift, slope, pads) if prologue
              else (None, _zero_pads(x, pads)))
    dt, dw, _ = torch.ops.aten.convolution_backward(
        g.to(x.dtype).permute(0, 4, 1, 2, 3), t.permute(0, 4, 1, 2, 3), w.to(x.dtype), None,
        [1, 1, 1], [0, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [need_t, needs[1], False])
    dw = dw.to(w.dtype) if needs[1] else None
    if not need_t:
        return None, dw, None, None
    dt = _zero_pads(dt.permute(0, 2, 3, 4, 1).float(), pads)
    if slope is not None:
        dt = torch.where(pre >= 0, dt, slope * dt)
    if scale is None:
        return dt.to(x.dtype), dw, None, None
    bshape = (b, 1, 1, 1, x.shape[-1])
    dx = (dt * scale.float().reshape(bshape)).to(x.dtype) if needs[0] else None
    dims = (1, 2, 3)
    return (dx, dw, (dt * x.float()).sum(dims).to(scale.dtype), dt.sum(dims).to(shift.dtype))


class _Conv3HaloMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, slope, pad_lo, pad_hi):
        ctx.set_materialize_grads(False)
        y, mean, m2 = _conv3_halo_moments(x, w, scale, shift, slope=slope, pad_lo=pad_lo,
                                          pad_hi=pad_hi)
        ctx.save_for_backward(x, w, scale, shift, y, mean)
        ctx.slope, ctx.pads = slope, (pad_lo, pad_hi)
        return y, mean, m2

    @staticmethod
    def backward(ctx, dy, dmean, dm2):
        x, w, scale, shift, y, mean = ctx.saved_tensors
        if dy is None and dmean is None and dm2 is None:
            return (None,) * 7
        grads = conv3_halo_moments_bwd(
            x, w, scale, shift, y, mean, dy, dmean, dm2, slope=ctx.slope, pad_lo=ctx.pads[0],
            pad_hi=ctx.pads[1], needs=ctx.needs_input_grad[:4])
        return (*grads, None, None, None)


def conv3_halo_moments(x, w, scale=None, shift=None, *, slope: float | None = None,
                       pad_lo: bool = False, pad_hi: bool = False):
    """K4's D-halo mode then the fold's moments mode: x `[B, Dl + 2, H, W,
    Cin]` (a D slab with one plane of each neighbour; `pad_lo`/`pad_hi`:
    that plane is the volume's own zero padding), w `[Cout, Cin, 3, 3, 3]`,
    scale/shift f32 `[B, Cin]` or None, `slope` a leaky-relu after the
    affine.  Returns (y `[B, Dl, H, W, Cout]` in x's dtype, each sample's
    f32 mean and M2 `[B, Cout]` of y).  On the card one K4 launch counted
    in `halo_launches` and one fold in `fold_moments_launches`; under grad
    mode inside an autograd Function (`conv3_halo_moments_bwd`); while
    tracing the op `miseg::conv3_halo_moments`."""
    if torch.compiler.is_compiling():
        y, mom = torch.ops.miseg.conv3_halo_moments(x, w, scale, shift, slope, pad_lo, pad_hi)
        return y, mom[0], mom[1]
    if torch.is_grad_enabled():
        return _Conv3HaloMoments.apply(x, w, scale, shift, slope, pad_lo, pad_hi)
    return _conv3_halo_moments(x, w, scale, shift, slope=slope, pad_lo=pad_lo, pad_hi=pad_hi)
