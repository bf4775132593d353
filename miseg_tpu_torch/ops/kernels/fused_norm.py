"""Fused instance norm (+affine, +residual add, +leaky-relu) — kernels K1,
K2 and K3.

Replaces the Pallas TPU kernels of miseg_tpu/ops/pallas/fused_norm.py:
  * K1 `_stats_kernel` (:78-87, `_stats` :115-128) with the fold of
    `norm_columns` (:160-197): per-channel statistics of x viewed
    `[B, S, C]`, folded with gamma/beta into f32 `scale, shift [B, C]`;
  * K2 `_apply_kernel`/`_apply_add_kernel` (:90-104, `_apply` :131-157):
    `y = leaky(x * scale[b, c] + shift[b, c] (+ add))`, f32 math, rounded
    once to x's dtype;
  * K3 `_apply2_kernel` (:278-286, `_apply2` :289-306): the UnetResBlock
    tail `leaky((x * sx + hx) + (r * sr + hr))` with both branches' norms
    folded into columns, f32 math, one rounding.
Public entries: `instance_norm_act` (the counterpart of
`fused_instance_norm_act` :463-491), `apply_norm_act` (:371) and
`apply_norm2_act` (:387).  K1's fold also serves K4 (`fused_conv`), whose
epilogue writes (mean, M2) partials per tile: `fold_partials`.

Spatial partitioning (`parallel/spatial.py`) takes K1 and the fold in
their moments mode: the same launches write each sample's f32 (mean, M2)
`[2, B, C]` of the rank's D slab in place of the columns
(`channel_moments`; `fold_launch(..., moments=True)` after K4's D-halo
mode), the ranks' moments are merged over the line, and the columns are
folded from the merged `[B, C]` moments in PyTorch (`columns_from_moments`,
the plain fold's own arithmetic).

K1 is CUDA C++ (`csrc/fused_norm.cu`, built by `build.py`, bound with
ctypes): `channel_scale_shift` is one launch of `miseg_k1_stats` and
`fold_partials` one launch of `miseg_k1_fold`.  Each finishes its
cross-CTA merge inside the launch: the last CTA to arrive on an integer
counter (`counters.py`) merges the partials in a fixed order, so a repeat
is bit-identical; the source's header says what bounds it and how.  The
statistics are two-pass over register tiles merged with Chan's formula,
never the TPU kernel's one-pass (sum, sum^2).  The grids are planned here
(`stats_grid`, `fold_grid`), where the CPU tests reach them.

K2 and K3 are CUDA C++ too (`csrc/norm_apply.cu`: `apply_scale_shift` is
one launch of `miseg_k2_apply`, `apply_norm2_act` one of
`miseg_k3_apply2`): streaming passes bound by their bytes (K3 at
[1, 96^3, 48] bf16 reads x and r and writes y, 255 MB), with 16-byte
accesses and each thread's columns held in registers; the source's header
says how.  Their grid is planned here (`apply_grid`), cached per shape,
and the wrappers' per-call Python is a few checks, one `empty_like` and
the ctypes call: the served window is host-bound.

The wrappers launch the kernels for CUDA tensors and use the plain
versions (`channel_scale_shift_plain`, `fold_partials_plain`,
`apply_scale_shift_plain`, `apply_norm2_act_plain`) only for CPU tensors.
The plain apply adds `add` in f32 before rounding, like the kernel (the
JAX package's plain tail adds after rounding).  K1, K2 and K3 are also
the registered ops `miseg::channel_scale_shift`, `miseg::apply_scale_shift`
and `miseg::apply_norm2_act`, which the wrappers call while tracing
(section "registered ops").
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch
import torch.nn.functional as F

from .. import norms as N
from . import build, counters

_APPLY_THREADS = 192    # a K2/K3 CTA's threads, rounded down to a multiple of C / vec
_APPLY_MIN_THREADS = 64    # ... rounded up, for tensors too small to give every SM a CTA
_APPLY_MAX_THREADS = 512   # kMaxThreads in csrc/norm_apply.cu
_APPLY_UNROLL = 4       # rows a K2/K3 step loads at once where CTAs take one step (kMaxUnroll)
_APPLY_WAVES = 4        # ... which they do where that makes this many waves of resident CTAs
_K1_THREADS = 256       # kMaxThreads in csrc/fused_norm.cu
_K1_UNROLL = 8          # rows a thread of miseg_k1_stats loads at once (kUnroll)
_K1_CTAS_PER_SM = 3
_K1_GROUPS = 8          # load groups a miseg_k1_stats channel block holds at most
_FOLD_MAX_C = 256       # channels a miseg_k1_fold CTA merges
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

stats_launches = 0   # K1 launches (channel_scale_shift) since last set to 0
fold_launches = 0    # K1 fold launches (fold_partials, after each K4) since last set to 0
moments_launches = 0       # K1 launches in moments mode (channel_moments) since last set to 0
fold_moments_launches = 0  # fold launches in moments mode (after K4's D-halo mode) since then
apply_launches = 0   # K2 launches since last set to 0
apply2_launches = 0  # K3 launches since last set to 0


# ---------------------------------------------------------------- plain ----

def _gamma_rows(gamma, beta, styles, bsz: int, c: int):
    """(gamma, beta) as f32 `[B, C]` rows, or None for the param-free norm."""
    if gamma is None:
        return None
    g, b = gamma.float(), beta.float()
    if g.ndim == 2:
        idx = styles.long().clamp(0, g.shape[0] - 1)
        return g[idx], b[idx]
    return g.expand(bsz, c), b.expand(bsz, c)


def _columns(mean, inv, gamma, beta, styles):
    """f32 (scale, shift) `[B, C]`: `scale = gamma * inv_std`,
    `shift = beta - mean * scale`."""
    rows = _gamma_rows(gamma, beta, styles, *mean.shape)
    if rows is None:
        return inv, -mean * inv
    scale = inv * rows[0]
    return scale, rows[1] - mean * scale


def channel_scale_shift_plain(x3, gamma=None, beta=None, styles=None, *,
                              eps: float = 1e-5):
    """x3 `[B, S, C]` -> f32 (scale, shift) `[B, C]` with
    `scale = gamma * inv_std`, `shift = beta - mean * scale`."""
    mean, inv = N.stats(x3, (1,), eps)
    return _columns(mean[:, 0], inv[:, 0], gamma, beta, styles)


def _merge(n, mean, m2, dim: int):
    """Merge (count, mean, M2) partials along `dim` in the exact parallel
    form: mean = sum(n_k mean_k) / n, M2 = sum(M2_k + n_k (mean_k - mean)^2)."""
    tot = n.sum(dim)
    mu = (n * mean).sum(dim) / tot
    d = mean - mu.unsqueeze(dim)
    return tot, mu, (m2 + n * d * d).sum(dim)


def channel_moments_plain(x3):
    """x3 `[B, S, C]` -> each sample's f32 (mean, M2) `[B, C]`, two-pass."""
    x32 = x3.float()
    mean = x32.mean(1)
    return mean, (x32 - mean[:, None, :]).square().sum(1)


def columns_from_moments(n, mean, m2, gamma=None, beta=None, styles=None, *,
                         eps: float = 1e-5):
    """f32 (scale, shift) `[B, C]` from the (count, mean, M2) of each
    sample's `n` voxels, with gamma/beta as in `channel_scale_shift`: the
    fold's arithmetic in PyTorch (differentiable)."""
    return _columns(mean, torch.rsqrt((m2 / n).clamp_min(0.0) + eps), gamma, beta, styles)


def fold_moments_plain(part, s: int, rows: int, n_chunks: int):
    """The fold in moments mode in plain PyTorch: per-chunk (mean, M2)
    partials `f32 [2, B*n_chunks, C]` of `rows`-row chunks of S rows (only
    a sample's last chunk short) -> each sample's (mean, M2) `[B, C]`,
    merged in the kernel's groups (`fold_grid`): each group of consecutive
    chunks, then the groups in order."""
    _, n_parts, c = part.shape
    bsz = n_parts // n_chunks
    group, n_groups, _ = fold_grid(n_chunks, c)
    pad = n_groups * group - n_chunks
    counts = (s - torch.arange(n_chunks, device=part.device) * rows).clamp(max=rows)
    counts = F.pad(counts.float(), (0, pad)).reshape(1, n_groups, group, 1)
    mean, m2 = (F.pad(p.float().reshape(bsz, n_chunks, c), (0, 0, 0, pad))
                .reshape(bsz, n_groups, group, c) for p in part)
    n_g, mean_g, m2_g = _merge(counts.expand(bsz, -1, -1, c), mean, m2, 2)
    _, mean, m2 = _merge(n_g, mean_g, m2_g, 1)
    return mean, m2


def fold_partials_plain(part, s: int, rows: int, n_chunks: int, gamma=None,
                        beta=None, styles=None, *, eps: float = 1e-5):
    """`fold_partials` in plain PyTorch: `fold_moments_plain`'s merge of
    the partials -> f32 (scale, shift) `[B, C]`."""
    mean, m2 = fold_moments_plain(part, s, rows, n_chunks)
    return columns_from_moments(s, mean, m2, gamma, beta, styles, eps=eps)


def apply_scale_shift_plain(x3, scale, shift, add3=None, *,
                            negative_slope: float | None = None):
    y = x3.float() * scale[:, None, :] + shift[:, None, :]
    if add3 is not None:
        y = y + add3.float()
    if negative_slope is not None:
        y = torch.where(y >= 0, y, negative_slope * y)
    return y.to(x3.dtype)


def apply_norm2_act_plain(x, sx, hx, res, sr, hr, *,
                          negative_slope: float | None = None):
    """`leaky((x * sx + hx) + (res * sr + hr))` over `[B, *spatial, C]`
    with f32 columns `[B, C]`, f32 math, rounded once to x's dtype."""
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = ((x.float() * sx.reshape(bshape) + hx.reshape(bshape))
         + (res.float() * sr.reshape(bshape) + hr.reshape(bshape)))
    if negative_slope is not None:
        y = torch.where(y >= 0, y, negative_slope * y)
    return y.to(x.dtype)


# -------------------------------------------------------------- kernels ----

@functools.lru_cache(maxsize=None)
def _k1():
    """The K1 library with its ctypes signatures (built on first use)."""
    lib = build.load("fused_norm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.miseg_k1_stats.restype = i32
    lib.miseg_k1_stats.argtypes = ([ptr, i32, i32, ptr, ptr, ptr, i32, i32, ptr, i32, ptr, ptr]
                                   + [i32] * 7 + [ctypes.c_float, i32, ptr])
    lib.miseg_k1_fold.restype = i32
    lib.miseg_k1_fold.argtypes = ([ptr, ptr, ptr, ptr, i32, i32, ptr, i32, ptr, ptr]
                                  + [i32] * 7 + [ctypes.c_float, i32, ptr])
    return lib


@functools.lru_cache(maxsize=None)
def _k23():
    """The K2/K3 library (`csrc/norm_apply.cu`) with its ctypes signatures
    (built on first use)."""
    lib = build.load("norm_apply")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32, i32, i32, ctypes.c_float, i32, ctypes.c_longlong, i32, i32, i32, i32, ptr]
    lib.miseg_k2_apply.restype = lib.miseg_k3_apply2.restype = i32
    lib.miseg_k2_apply.argtypes = [ptr] * 5 + tail
    lib.miseg_k3_apply2.argtypes = [ptr] * 7 + tail
    lib.miseg_k23_resident.restype = i32
    lib.miseg_k23_resident.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def apply_vec(c: int, element_size: int) -> int:
    """Elements a K2/K3 load takes over C channels of this size: 16 bytes'
    worth where they divide C and a CTA can give each of the C / vec
    channel groups a thread, else 1 (the scalar variant).  The wrapper also
    takes 1 when an operand is not 16-byte aligned."""
    vec = 16 // element_size
    return vec if c % vec == 0 and c // vec <= _APPLY_MAX_THREADS else 1


@functools.lru_cache(maxsize=None)
def apply_grid(bsz: int, n: int, c: int, vec: int, num_sms: int, ctas_per_sm: int):
    """(threads, ctas_per_sample, unroll) for `miseg_k2_apply` /
    `miseg_k3_apply2` over `[B, n]` (n = S * C elements a sample) loaded
    `vec` at a time, on a card of `num_sms` SMs that holds `ctas_per_sm`
    of the kernel's CTAs at once (the wrappers ask the card).

    Threads are a multiple of the C / vec channel groups, so a thread's
    channel group is the same on every step: about 192, or, where CTAs of
    that size would leave SMs without one, the fewest of at least 64, so
    that a small tensor spreads over more SMs.  A sample is cut into rows
    of `threads` vectors.  Where steps of 4 rows make at least 4 waves of
    the CTAs the card holds, each CTA takes one step: the card schedules
    the short CTAs as SMs free up, and the last, partial wave is a small
    share.  Otherwise at most one wave of CTAs strides over steps of 2
    rows, which spares a partial second wave.  (On the H100 each rule beat
    the other on its side of the line at the main-path shapes.)  Cached:
    the plan is made once per shape, not on every call."""
    groups = c // vec if vec > 1 else 1
    nvec = math.ceil(n / vec)
    threads = groups * max(1, _APPLY_THREADS // groups)
    if bsz * math.ceil(nvec / threads) < num_sms:
        threads = groups * math.ceil(_APPLY_MIN_THREADS / groups)
    rows = math.ceil(nvec / threads)
    wave = max(1, ctas_per_sm * num_sms // bsz)   # CTAs a sample in one wave
    if math.ceil(rows / _APPLY_UNROLL) >= _APPLY_WAVES * wave:
        return threads, math.ceil(rows / _APPLY_UNROLL), _APPLY_UNROLL
    return threads, min(math.ceil(rows / 2), wave), 2


@functools.lru_cache(maxsize=None)
def _apply_plan(index: int, mode: int, dtype: int, slope: bool, bsz: int, n: int, c: int,
                vec: int):
    """`apply_grid` on card `index` for the K2/K3 instance of mode (0
    apply, 1 apply + add, 2 K3), dtype, vec and slope, with the CTAs an SM
    holds of it (asked of the card once per instance and shape)."""
    threads = apply_grid(bsz, n, c, vec, _num_sms(index), 1)[0]   # threads need no capacity
    resident = ctypes.c_int()
    with torch.cuda.device(index):   # the query reads the current card
        err = _k23().miseg_k23_resident(mode, dtype, vec, slope, threads,
                                        ctypes.byref(resident))
    if err != 0 or resident.value < 1:
        raise RuntimeError(f"K2/K3 occupancy query failed: CUDA error {err}")
    return apply_grid(bsz, n, c, vec, _num_sms(index), resident.value)


@functools.lru_cache(maxsize=None)
def stats_grid(bsz: int, s: int, c: int, num_sms: int, vec: int):
    """(block_c, threads, rows, n_chunks) for `miseg_k1_stats` on a card of
    `num_sms` SMs, loading `vec` channels at a time.

    Channel blocks hold at most `_K1_GROUPS` groups of vec channels (whole
    rows at C = 48 in bf16), each thread keeping one group; where rows are
    too few to give every SM a CTA, the blocks halve until they do (if none
    does, the blocks that give the most CTAs, the widest of equals).  Row
    chunks are whole steps (a step: `_K1_UNROLL` rows of every lane), and
    their count, at most about three CTAs per SM, is the one with the fewest
    dependent memory round trips a thread waits for: its steps, plus, when a
    sample spans several chunks, the arrival (two) and the last CTA's merge
    of the chunks' partials (4 a lane at a time, as float4s).  Cached: the
    search runs once per shape, not on every call."""
    groups = math.ceil(c / vec)

    def ctas(bg: int) -> int:
        min_rows = _K1_THREADS // bg * _K1_UNROLL   # one step of every lane
        return bsz * math.ceil(groups / bg) * math.ceil(s / min_rows)

    widths = [math.ceil(groups / math.ceil(groups / _K1_GROUPS))]   # even blocks
    while ctas(widths[-1]) < num_sms and widths[-1] > 1:
        widths.append(math.ceil(widths[-1] / 2))
    block_groups = widths[-1] if ctas(widths[-1]) >= num_sms else max(widths, key=ctas)
    lanes = _K1_THREADS // block_groups
    threads, block_c = block_groups * lanes, block_groups * vec
    n_cblocks = math.ceil(c / block_c)
    step = lanes * _K1_UNROLL
    merge_lanes = max(1, threads // math.ceil(min(block_c, c) / 4))

    def plan(n: int):
        rows = math.ceil(math.ceil(s / n) / step) * step
        return rows, math.ceil(s / rows)

    def trips(n: int) -> int:
        rows, n = plan(n)
        return rows // step + (2 + math.ceil(n / (4 * merge_lanes)) if n > 1 else 0)

    most = max(1, min(math.ceil(s / step),
                      math.ceil(_K1_CTAS_PER_SM * num_sms / (bsz * n_cblocks))))
    best = min(range(most, 0, -1), key=trips)   # the most chunks among the fewest trips
    rows, n_chunks = plan(best)
    return block_c, threads, rows, n_chunks


@functools.lru_cache(maxsize=None)
def fold_grid(n_chunks: int, c: int):
    """(group, n_groups, block_c) for `miseg_k1_fold`: groups of about
    sqrt(n_chunks) consecutive partials (a power of 2, at least 8), so the
    group merges and the last CTA's merge of the groups are about as long,
    and channel blocks of at most 256 channels."""
    group = max(8, 1 << math.ceil(math.log2(math.sqrt(n_chunks))))
    return group, math.ceil(n_chunks / group), min(c, _FOLD_MAX_C)


def _check_cuda(x3, *others):
    if x3.dtype not in _DTYPES:
        raise ValueError(f"fused norm takes float tensors, got {x3.dtype}")
    if not x3.is_contiguous():
        raise ValueError("fused norm kernels take a contiguous [B, S, C] tensor")
    index = x3.get_device()
    for t in others:
        if t is not None and t.get_device() != index:
            raise ValueError("all operands must be on one device")


def _affine(gamma, beta, styles):
    """K1's affine operands: (tensors to keep alive, ctypes arguments
    gamma, beta, dtype, mode, styles, n_styles) with mode 0 = no affine,
    1 = `[C]`, 2 = `[S, C]` banks with int32 style ids (the kernel clamps
    them)."""
    if gamma is None:
        return (), (None, None, 0, 0, None, 0)
    if gamma.dtype not in _DTYPES or beta.dtype != gamma.dtype:
        gamma, beta = gamma.float(), beta.float()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if gamma.ndim == 1:
        return (gamma, beta), (gamma.data_ptr(), beta.data_ptr(), _DTYPES[gamma.dtype], 1,
                               None, 0)
    styles = styles.to(torch.int32).contiguous()
    return (gamma, beta, styles), (gamma.data_ptr(), beta.data_ptr(), _DTYPES[gamma.dtype], 2,
                                   styles.data_ptr(), gamma.shape[0])


def _ptr(t):
    return t.data_ptr() if t is not None else None


def fold_partials(part, s: int, rows: int, n_chunks: int, gamma=None,
                  beta=None, styles=None, *, eps: float = 1e-5):
    """K1's fold: per-chunk (mean, M2) partials `f32 [2, B*n_chunks, C]` of
    `rows`-row chunks of S rows (only a sample's last chunk short; K4's
    tiles) -> f32 (scale, shift) `[B, C]`, with gamma/beta as in
    `channel_scale_shift`.  On the card one launch of `miseg_k1_fold`,
    counted in `fold_launches`; on the CPU `fold_partials_plain`."""
    if part.device.type == "cpu":
        return fold_partials_plain(part, s, rows, n_chunks, gamma, beta, styles, eps=eps)
    out = fold_launch(part, s, rows, n_chunks, gamma, beta, styles, eps=eps)
    return out[0], out[1]


def fold_launch(part, s: int, rows: int, n_chunks: int, gamma=None, beta=None,
                styles=None, *, eps: float = 1e-5, moments: bool = False) -> torch.Tensor:
    """One launch of `miseg_k1_fold` (`fold_partials` on the card): f32
    (scale, shift) stacked `[2, B, C]`; with `moments` (no gamma/beta),
    each sample's (mean, M2), counted in `fold_moments_launches`."""
    if part.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {part.device}")
    if part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("partials must be a contiguous float32 [2, B * n_chunks, C]")
    _check_cuda(part, gamma, beta, styles)
    _, n_parts, c = part.shape
    bsz = n_parts // n_chunks
    group, n_groups, block_c = fold_grid(n_chunks, c)
    keep, aff = _affine(gamma, beta, styles)
    out = torch.empty((2, bsz, c), dtype=torch.float32, device=part.device)
    work = (torch.empty((2, bsz * n_groups, c), dtype=torch.float32, device=part.device)
            if n_groups > 1 else None)
    stream = torch.cuda.current_stream(part.device).cuda_stream
    with torch.cuda.device(part.device):
        ctrs = counters.arrival_counters(part.device, stream,
                                         bsz * math.ceil(c / block_c) if n_groups > 1 else 0)
        err = _k1().miseg_k1_fold(part.data_ptr(), _ptr(work), *aff, out.data_ptr(), _ptr(ctrs),
                                  bsz, s, c, rows, n_chunks, group, block_c, float(eps),
                                  int(moments), stream)
    if err != 0:
        raise RuntimeError(f"K1 fold kernel launch failed: CUDA error {err}")
    del keep
    global fold_launches, fold_moments_launches
    if moments:
        fold_moments_launches += 1
    else:
        fold_launches += 1
    return out


def _check_banks(gamma, styles):
    if gamma is not None and gamma.ndim == 2 and styles is None:
        raise ValueError("conditional banks need a styles vector")


def _stats_launch(x3, gamma, beta, styles, eps: float, moments: bool = False) -> torch.Tensor:
    """One launch of `miseg_k1_stats` over a CUDA x3: f32 (scale, shift)
    stacked `[2, B, C]`; with `moments` (no gamma/beta) each sample's
    (mean, M2), counted in `moments_launches`."""
    if x3.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x3.device}")
    _check_cuda(x3, gamma, beta, styles)
    bsz, s, c = x3.shape
    vec = 16 // x3.element_size()
    if c % vec or x3.data_ptr() % 16:
        vec = 1
    block_c, threads, rows, n_chunks = stats_grid(bsz, s, c, _num_sms(x3.device.index), vec)
    keep, aff = _affine(gamma, beta, styles)
    out = torch.empty((2, bsz, c), dtype=torch.float32, device=x3.device)
    part = (torch.empty((2, bsz * n_chunks, c), dtype=torch.float32, device=x3.device)
            if n_chunks > 1 else None)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    with torch.cuda.device(x3.device):
        ctrs = counters.arrival_counters(x3.device, stream,
                                         bsz * math.ceil(c / block_c) if n_chunks > 1 else 0)
        err = _k1().miseg_k1_stats(x3.data_ptr(), _DTYPES[x3.dtype], vec, _ptr(part), *aff,
                                   out.data_ptr(), _ptr(ctrs), bsz, s, c, rows, n_chunks,
                                   block_c, threads, float(eps), int(moments), stream)
    if err != 0:
        raise RuntimeError(f"K1 kernel launch failed: CUDA error {err}")
    del keep
    global stats_launches, moments_launches
    if moments:
        moments_launches += 1
    else:
        stats_launches += 1
    return out


def _channel_scale_shift(x3, gamma=None, beta=None, styles=None, *,
                         eps: float = 1e-5):
    """K1 without autograd (`channel_scale_shift`)."""
    _check_banks(gamma, styles)
    if x3.device.type == "cpu":
        return channel_scale_shift_plain(x3, gamma, beta, styles, eps=eps)
    out = _stats_launch(x3, gamma, beta, styles, eps)
    return out[0], out[1]


def _f32(v):
    """A column as K2/K3 read it: f32 and contiguous (K1's columns already
    are, and pass without a copy)."""
    return v if v.dtype == torch.float32 and v.is_contiguous() else v.float().contiguous()


def _apply(fn, mode: int, x, bsz: int, c: int, negative_slope, ptrs):
    """Launch K2 or K3 (`fn`, its ctypes entry; mode 0 apply, 1 apply +
    add, 2 K3) over x `[B, ...]` with the pointer arguments `ptrs` (0 for
    none) on the current stream of x's card.  Any operand off a 16-byte
    boundary takes the scalar variant."""
    index = x.get_device()
    vec = 1 if functools.reduce(operator.or_, ptrs) % 16 else apply_vec(c, x.element_size())
    n = x.numel() // bsz
    dtype, slope = _DTYPES[x.dtype], negative_slope is not None
    threads, ctas, unroll = _apply_plan(index, mode, dtype, slope, bsz, n, c, vec)
    args = (*ptrs, dtype, vec, slope, float(negative_slope or 0.0), bsz, n, c, threads, ctas,
            unroll)
    # the raw stream handle: `torch.cuda.current_stream(...).cuda_stream`
    # builds a Stream object, several us of host time a call.  The call is
    # private API of torch (checked against torch 2.11 with CUDA 12.8).
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _check_apply(x3, add3):
    if add3 is not None and add3.shape != x3.shape:
        raise ValueError(f"add shape {tuple(add3.shape)} != {tuple(x3.shape)}")


def _apply_launch(x3, scale, shift, add3, negative_slope):
    """One launch of `miseg_k2_apply` over a CUDA x3."""
    if x3.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x3.device}")
    _check_cuda(x3, scale, shift, add3)
    if add3 is not None and (add3.dtype != x3.dtype or not add3.is_contiguous()):
        raise ValueError("add must be contiguous and of x's dtype")
    bsz, _, c = x3.shape
    if scale.shape != (bsz, c) or shift.shape != (bsz, c):
        raise ValueError(f"columns must be [B, C] = {[bsz, c]}")
    scale, shift = _f32(scale), _f32(shift)
    y = torch.empty_like(x3)
    _apply(_k23().miseg_k2_apply, int(add3 is not None), x3, bsz, c, negative_slope,
           (x3.data_ptr(), add3.data_ptr() if add3 is not None else 0, scale.data_ptr(),
            shift.data_ptr(), y.data_ptr()))
    global apply_launches
    apply_launches += 1
    return y


def _apply_scale_shift(x3, scale, shift, add3=None, *,
                       negative_slope: float | None = None):
    """K2 without autograd (`apply_scale_shift`)."""
    _check_apply(x3, add3)
    if x3.device.type == "cpu":
        return apply_scale_shift_plain(x3, scale, shift, add3,
                                       negative_slope=negative_slope)
    return _apply_launch(x3, scale, shift, add3, negative_slope)


def _check_apply2(x, sx, hx, res, sr, hr):
    if res.shape != x.shape:
        raise ValueError(f"residual shape {tuple(res.shape)} != {tuple(x.shape)}")
    cols = (x.shape[0], x.shape[-1])
    if any(tuple(v.shape) != cols for v in (sx, hx, sr, hr)):
        raise ValueError(f"columns must be [B, C] = {list(cols)}")


def _apply2_launch(x, sx, hx, res, sr, hr, negative_slope):
    """One launch of `miseg_k3_apply2` over a CUDA x."""
    if x.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x.device}")
    _check_cuda(x, sx, hx, res, sr, hr)
    if res.dtype != x.dtype or not res.is_contiguous():
        raise ValueError("the residual must be contiguous and of x's dtype")
    bsz, c = x.shape[0], x.shape[-1]
    sx, hx, sr, hr = _f32(sx), _f32(hx), _f32(sr), _f32(hr)
    y = torch.empty_like(x)
    _apply(_k23().miseg_k3_apply2, 2, x, bsz, c, negative_slope,
           (x.data_ptr(), sx.data_ptr(), hx.data_ptr(), res.data_ptr(), sr.data_ptr(),
            hr.data_ptr(), y.data_ptr()))
    global apply2_launches
    apply2_launches += 1
    return y


def _apply_norm2_act(x, sx, hx, res, sr, hr, *,
                     negative_slope: float | None = None):
    """K3 without autograd (`apply_norm2_act`)."""
    _check_apply2(x, sx, hx, res, sr, hr)
    if x.device.type == "cpu":
        return apply_norm2_act_plain(x, sx, hx, res, sr, hr,
                                     negative_slope=negative_slope)
    return _apply2_launch(x, sx, hx, res, sr, hr, negative_slope)


# -------------------------------------------------------- registered ops ----
#
# Each kernel entry is also a `torch.library` op, `miseg::<name>`, with a
# fake implementation (shapes and dtypes only), a "cpu" kernel (the plain
# version) and a "cuda" kernel (the hand-written one, which raises if it
# fails).  The public wrappers call the ops only while tracing
# (`torch.compiler.is_compiling()`, true under `torch.export`): a traced
# graph then holds `miseg::` nodes in place of the kernels, never the
# plain code that a trace on the CPU would otherwise record, and a loaded
# exported program launches the kernels through the dispatcher.  Eager
# calls go straight to the launchers, without the dispatcher's host cost.
# The ops have no autograd of their own: training runs eagerly, through
# the autograd Functions below.  K1's op returns (scale, shift) stacked
# `[2, B, C]`, one fresh tensor, since an op's outputs may not share
# storage.

@torch.library.custom_op("miseg::channel_scale_shift", mutates_args=())
def channel_scale_shift_op(x3: torch.Tensor, gamma: torch.Tensor | None,
                           beta: torch.Tensor | None, styles: torch.Tensor | None,
                           eps: float) -> torch.Tensor:
    """K1: f32 (scale, shift) stacked `[2, B, C]`."""
    raise ValueError(f"miseg::channel_scale_shift: unsupported device {x3.device}")


@channel_scale_shift_op.register_kernel("cpu")
def _(x3, gamma, beta, styles, eps):
    return torch.stack(_channel_scale_shift(x3, gamma, beta, styles, eps=eps))


@channel_scale_shift_op.register_kernel("cuda")
def _(x3, gamma, beta, styles, eps):
    _check_banks(gamma, styles)
    return _stats_launch(x3, gamma, beta, styles, eps)


@channel_scale_shift_op.register_fake
def _(x3, gamma, beta, styles, eps):
    _check_banks(gamma, styles)
    return x3.new_empty((2, x3.shape[0], x3.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("miseg::apply_scale_shift", mutates_args=())
def apply_scale_shift_op(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         add3: torch.Tensor | None,
                         negative_slope: float | None) -> torch.Tensor:
    """K2: `leaky(x3 * scale + shift (+ add3))` in x3's dtype."""
    raise ValueError(f"miseg::apply_scale_shift: unsupported device {x3.device}")


@apply_scale_shift_op.register_kernel("cpu")
def _(x3, scale, shift, add3, negative_slope):
    return _apply_scale_shift(x3, scale, shift, add3, negative_slope=negative_slope)


@apply_scale_shift_op.register_kernel("cuda")
def _(x3, scale, shift, add3, negative_slope):
    _check_apply(x3, add3)
    return _apply_launch(x3, scale, shift, add3, negative_slope)


@apply_scale_shift_op.register_fake
def _(x3, scale, shift, add3, negative_slope):
    _check_apply(x3, add3)
    return torch.empty_like(x3, memory_format=torch.contiguous_format)


@torch.library.custom_op("miseg::apply_norm2_act", mutates_args=())
def apply_norm2_act_op(x: torch.Tensor, sx: torch.Tensor, hx: torch.Tensor,
                       res: torch.Tensor, sr: torch.Tensor, hr: torch.Tensor,
                       negative_slope: float | None) -> torch.Tensor:
    """K3: `leaky((x * sx + hx) + (res * sr + hr))` in x's dtype."""
    raise ValueError(f"miseg::apply_norm2_act: unsupported device {x.device}")


@apply_norm2_act_op.register_kernel("cpu")
def _(x, sx, hx, res, sr, hr, negative_slope):
    return _apply_norm2_act(x, sx, hx, res, sr, hr, negative_slope=negative_slope)


@apply_norm2_act_op.register_kernel("cuda")
def _(x, sx, hx, res, sr, hr, negative_slope):
    _check_apply2(x, sx, hx, res, sr, hr)
    return _apply2_launch(x, sx, hx, res, sr, hr, negative_slope)


@apply_norm2_act_op.register_fake
def _(x, sx, hx, res, sr, hr, negative_slope):
    _check_apply2(x, sx, hx, res, sr, hr)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ------------------------------------------------------------- autograd ----
#
# The JAX package computes every VJP of these kernels in jnp
# (fused_norm.py:231 `_fin_bwd`, :314 `_apply2_bwd`, :352 `_apply1_bwd`,
# :441 `_stats_p_bwd`), so the backward passes below are PyTorch ops,
# the same code on the CPU and on the card.  Under grad mode the public
# wrappers run inside a `torch.autograd.Function` whose forward is the
# launcher above (the kernel on the card); with grad mode off (serving
# runs under `inference_mode`) they call the launcher directly: the same
# kernel without autograd's per-call host cost.

def _leaky_grad(dy, y, negative_slope):
    """f32 cotangent through the leaky-relu, its mask from the sign of the
    saved output (leaky-relu keeps the sign), as JAX does."""
    g = dy.float()
    return g if negative_slope is None else torch.where(y >= 0, g, negative_slope * g)


def channel_scale_shift_bwd(x3, gamma, beta, styles, dscale, dshift, *,
                            eps: float = 1e-5):
    """VJP of `channel_scale_shift`: the cotangents of (scale, shift) f32
    `[B, C]` (either may be None) -> (dx f32 `[B, S, C]`, dgamma, dbeta).

    mean and inv_std are recomputed (two-pass) from the saved x; the scale
    is never divided by gamma, which may be 0.  With `scale = inv * g` and
    `shift = b - mean * scale`: dg = inv (dscale - mean dshift), db =
    dshift, and x takes the VJP of (mean, inv) over its S rows.
    `[n_styles, C]` banks take their rows' gradients summed by the clamped
    style id (`_fin_bwd` :260-268)."""
    bsz, s, c = x3.shape
    mean, inv = N.stats(x3, (1,), eps)
    xc = x3.float() - mean                                   # [B, S, C]
    mean, inv = mean[:, 0], inv[:, 0]
    zero = torch.zeros_like(mean)
    dscale = zero if dscale is None else dscale.float()
    dshift = zero if dshift is None else dshift.float()
    rows = _gamma_rows(gamma, beta, styles, bsz, c)
    g = rows[0] if rows is not None else 1.0
    u = dscale - mean * dshift
    dmean = -dshift * inv * g
    dvar = -0.5 * inv ** 3 * (u * g)
    dx = (dmean[:, None, :] + 2.0 * dvar[:, None, :] * xc) / s
    if gamma is None:
        return dx, None, None
    dg_rows, db_rows = u * inv, dshift
    if gamma.ndim == 2:
        onehot = F.one_hot(styles.long().clamp(0, gamma.shape[0] - 1),
                           gamma.shape[0]).float()                 # [B, n_styles]
        dgamma, dbeta = onehot.t() @ dg_rows, onehot.t() @ db_rows
    else:
        dgamma, dbeta = dg_rows.sum(0), db_rows.sum(0)
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def apply_scale_shift_bwd(x3, scale, y, dy, *, negative_slope=None, has_add=False):
    """VJP of `apply_scale_shift` (`_apply1_bwd` :352; the add's cotangent
    as in `_fin_bwd` :240): -> (dx, dscale, dshift, dadd or None)."""
    g = _leaky_grad(dy, y, negative_slope)
    dx = (g * scale.float()[:, None, :]).to(x3.dtype)
    dadd = g.to(x3.dtype) if has_add else None
    return dx, (g * x3.float()).sum(1), g.sum(1), dadd


def apply_norm2_act_bwd(x, sx, res, sr, y, dy, *, negative_slope=None):
    """VJP of `apply_norm2_act` (`_apply2_bwd` :314): -> (dx, dsx, dhx,
    dres, dsr, dhr)."""
    g = _leaky_grad(dy, y, negative_slope)
    dims = tuple(range(1, x.ndim - 1))
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    dh = g.sum(dims)
    return ((g * sx.float().reshape(bshape)).to(x.dtype), (g * x.float()).sum(dims), dh,
            (g * sr.float().reshape(bshape)).to(res.dtype), (g * res.float()).sum(dims), dh)


class _ChannelScaleShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, gamma, beta, styles, eps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x3, gamma, beta, styles)
        ctx.eps = eps
        return _channel_scale_shift(x3, gamma, beta, styles, eps=eps)

    @staticmethod
    def backward(ctx, dscale, dshift):
        x3, gamma, beta, styles = ctx.saved_tensors
        if dscale is None and dshift is None:
            return None, None, None, None, None
        dx, dgamma, dbeta = channel_scale_shift_bwd(x3, gamma, beta, styles, dscale, dshift,
                                                    eps=ctx.eps)
        return dx.to(x3.dtype), dgamma, dbeta, None, None


def channel_moments_bwd(x3, mean, dmean, dm2):
    """VJP of `channel_moments`: with `mean = sum(x) / S` and `M2 =
    sum((x - mean)^2)`, `dx = dmean / S + 2 (x - mean) dM2` (f32)."""
    s = x3.shape[1]
    dx = torch.zeros(x3.shape, dtype=torch.float32, device=x3.device)
    if dmean is not None:
        dx = dx + dmean.float()[:, None, :] / s
    if dm2 is not None:
        dx = dx + 2.0 * (x3.float() - mean[:, None, :]) * dm2.float()[:, None, :]
    return dx


class _ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3):
        ctx.set_materialize_grads(False)
        mean, m2 = _channel_moments(x3)
        ctx.save_for_backward(x3, mean)
        return mean, m2

    @staticmethod
    def backward(ctx, dmean, dm2):
        x3, mean = ctx.saved_tensors
        if dmean is None and dm2 is None:
            return None
        return channel_moments_bwd(x3, mean, dmean, dm2).to(x3.dtype)


def _channel_moments(x3):
    """K1's moments mode without autograd (`channel_moments`)."""
    if x3.device.type == "cpu":
        return channel_moments_plain(x3)
    out = _stats_launch(x3, None, None, None, 1e-5, moments=True)
    return out[0], out[1]


def channel_moments(x3):
    """K1 in moments mode: x3 `[B, S, C]` -> each sample's f32 (mean, M2)
    `[B, C]` over its S rows (spatial partitioning merges them over the
    line).  On the card one launch of `miseg_k1_stats`, counted in
    `moments_launches`; differentiable (`channel_moments_bwd`)."""
    if torch.is_grad_enabled():
        return _ChannelMoments.apply(x3)
    return _channel_moments(x3)


class _ApplyScaleShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, scale, shift, add3, negative_slope):
        y = _apply_scale_shift(x3, scale, shift, add3, negative_slope=negative_slope)
        ctx.save_for_backward(x3, scale, y if negative_slope is not None else None)
        ctx.slope, ctx.has_add = negative_slope, add3 is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x3, scale, y = ctx.saved_tensors
        return (*apply_scale_shift_bwd(x3, scale, y, dy, negative_slope=ctx.slope,
                                       has_add=ctx.has_add), None)


class _ApplyNorm2Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sx, hx, res, sr, hr, negative_slope):
        y = _apply_norm2_act(x, sx, hx, res, sr, hr, negative_slope=negative_slope)
        ctx.save_for_backward(x, sx, res, sr, y if negative_slope is not None else None)
        ctx.slope = negative_slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sx, res, sr, y = ctx.saved_tensors
        return (*apply_norm2_act_bwd(x, sx, res, sr, y, dy, negative_slope=ctx.slope), None)


def channel_scale_shift(x3, gamma=None, beta=None, styles=None, *,
                        eps: float = 1e-5):
    """K1: x3 `[B, S, C]` -> f32 (scale, shift) `[B, C]`.  gamma/beta:
    None, `[C]`, or `[num_styles, C]` banks gathered by `styles: int[B]`
    (clamped).  On the card one launch of `miseg_k1_stats`; differentiable
    in x, gamma and beta (`channel_scale_shift_bwd`)."""
    if torch.compiler.is_compiling():
        out = torch.ops.miseg.channel_scale_shift(x3, gamma, beta, styles, eps)
        return out[0], out[1]
    if torch.is_grad_enabled():
        return _ChannelScaleShift.apply(x3, gamma, beta, styles, eps)
    return _channel_scale_shift(x3, gamma, beta, styles, eps=eps)


def apply_scale_shift(x3, scale, shift, add3=None, *,
                      negative_slope: float | None = None):
    """K2: `leaky(x3 * scale + shift (+ add3))` with f32 columns `[B, C]`,
    rounded once to x3's dtype.  On the card one launch of
    `miseg_k2_apply`; differentiable (`apply_scale_shift_bwd`)."""
    if torch.compiler.is_compiling():
        return torch.ops.miseg.apply_scale_shift(x3, scale, shift, add3, negative_slope)
    if torch.is_grad_enabled():
        return _ApplyScaleShift.apply(x3, scale, shift, add3, negative_slope)
    return _apply_scale_shift(x3, scale, shift, add3, negative_slope=negative_slope)


def apply_norm2_act(x, sx, hx, res, sr, hr, *,
                    negative_slope: float | None = None):
    """K3: `leaky((x * sx + hx) + (res * sr + hr))` over `[B, *spatial, C]`
    with f32 columns `[B, C]`, rounded once to x's dtype — the UnetResBlock
    tail with both branches' instance norms folded into columns.  On the
    card one launch of `miseg_k3_apply2`; differentiable
    (`apply_norm2_act_bwd`)."""
    if torch.compiler.is_compiling():
        return torch.ops.miseg.apply_norm2_act(x, sx, hx, res, sr, hr, negative_slope)
    if torch.is_grad_enabled():
        return _ApplyNorm2Act.apply(x, sx, hx, res, sr, hr, negative_slope)
    return _apply_norm2_act(x, sx, hx, res, sr, hr, negative_slope=negative_slope)


def instance_norm_act(x, gamma=None, beta=None, styles=None, *,
                      eps: float = 1e-5, negative_slope: float | None = None,
                      add=None):
    """Instance norm over `[B, *spatial, C]` with the affine (none, `[C]`,
    or `[S, C]` banks by `styles`), a residual `add` after the affine and
    an optional leaky-relu, in two kernels: K1 then K2."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    add3 = add.reshape(x3.shape) if add is not None else None
    scale, shift = channel_scale_shift(x3, gamma, beta, styles, eps=eps)
    y = apply_scale_shift(x3, scale, shift, add3, negative_slope=negative_slope)
    return y.reshape(shape)


def apply_norm_act(x, sx, hx, *, negative_slope: float | None = None):
    """K2 on `[B, *spatial, C]` with f32 columns `[B, C]`: `leaky(x * sx +
    hx)` (the counterpart of `apply_norm_act`, fused_norm.py:371)."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    return apply_scale_shift(x3, sx, hx, negative_slope=negative_slope).reshape(x.shape)


