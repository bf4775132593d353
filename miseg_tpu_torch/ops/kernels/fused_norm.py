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
epilogue writes partials in pass 1's layout: `fold_partials`.

All three are Triton kernels: bandwidth-bound, with no tensor-core work,
which Triton's masked block loads and reductions express directly.

K1 is bound by reading x once (at [1, 96^3, 48] bf16: 85 MB, ~25 us at
3.35 TB/s).  The TPU kernel accumulates (sum, sum^2) over a sequential
grid and folds to a ONE-pass variance, which loses digits when
var << mean^2.  Here blocks run in parallel, so pass 1 gives every
(sample, row chunk, channel block) program its own partial
(mean, M2) — tiles merged with Chan's formula, each tile's M2 taken
two-pass in registers — and pass 2 merges the chunk partials per channel,
64 chunks per step (the exact parallel form of the same merge), and folds
in gamma/beta (none, [C], or the [S, C] bank row of the clamped style id).
The chunk count is chosen so pass 1's grid holds at least a few programs
per SM at both main-path extremes (S=884,736, C=48 and S=27, C=3072).

K2 is bound by reading x (and `add`) and writing y once (170 MB, or 255 MB
with `add`, at [1, 96^3, 48] bf16).  It walks the flat `[B, S*C]` view in
contiguous blocks, so every load is coalesced whatever C is.  K3 is K2's
pass over two inputs (255 MB at [1, 96^3, 48] bf16) and walks the same way.

The wrappers launch the kernels for CUDA tensors and use the plain
versions (`channel_scale_shift_plain`, `apply_scale_shift_plain`,
`apply_norm2_act_plain`) only for CPU tensors.  The plain apply adds `add`
in f32 before rounding, like the kernel (the JAX package's plain tail adds
after rounding).
"""

from __future__ import annotations

import functools
import math
import types

import torch

from .. import norms as N

_STATS_BLOCK_S = 64
_APPLY_BLOCK = 2048
_FOLD_BLOCK_C = 64
_FOLD_BLOCK_K = 64
_MERGE_GROUP = 64      # partials merged per program ahead of a long fold
_MERGE_ABOVE = 256     # fold more partials per sample than this: merge first
_PROGRAMS_PER_SM = 4

stats_launches = 0   # K1 runs (pass 1 + pass 2) since last set to 0
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


def channel_scale_shift_plain(x3, gamma=None, beta=None, styles=None, *,
                              eps: float = 1e-5):
    """x3 `[B, S, C]` -> f32 (scale, shift) `[B, C]` with
    `scale = gamma * inv_std`, `shift = beta - mean * scale`."""
    mean, inv = N.stats(x3, (1,), eps)
    mean, inv = mean[:, 0], inv[:, 0]
    rows = _gamma_rows(gamma, beta, styles, x3.shape[0], x3.shape[2])
    if rows is None:
        return inv, -mean * inv
    scale = inv * rows[0]
    return scale, rows[1] - mean * scale


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
def _kernels():
    """Define the Triton kernels on first use (triton exists only where a
    card does; importing this module must not need it)."""
    import triton
    import triton.language as tl

    @triton.jit
    def miseg_k1_stats_partial(x_ptr, part_ptr, S, C, rows_per_chunk, n_chunks,
                               BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)                 # b * n_chunks + chunk
        b = pid // n_chunks
        chunk = pid % n_chunks
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        row0 = chunk * rows_per_chunk
        row_end = tl.minimum(row0 + rows_per_chunk, S)
        xb = x_ptr + b.to(tl.int64) * S * C
        cnt = tl.zeros([BLOCK_C], tl.float32)
        mean = tl.zeros([BLOCK_C], tl.float32)
        m2 = tl.zeros([BLOCK_C], tl.float32)
        for r in range(row0, row_end, BLOCK_S):
            rows = r + tl.arange(0, BLOCK_S)
            rmask = rows < row_end
            m = rmask[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(xb + offs, mask=m, other=0.0).to(tl.float32)
            nt = tl.sum(rmask.to(tl.float32), axis=0)
            tmean = tl.sum(x, axis=0) / nt
            dev = tl.where(m, x - tmean[None, :], 0.0)
            tm2 = tl.sum(dev * dev, axis=0)
            tot = cnt + nt
            delta = tmean - mean
            mean = mean + delta * (nt / tot)
            m2 = m2 + tm2 + delta * delta * (cnt * nt / tot)
            cnt = tot
        out = pid.to(tl.int64) * C + cols
        tl.store(part_ptr + out, mean, mask=cmask)
        tl.store(part_ptr + (pid.to(tl.int64) + tl.num_programs(0)) * C + cols,
                 m2, mask=cmask)

    @triton.jit
    def miseg_k1_stats_fold(part_ptr, gamma_ptr, beta_ptr, styles_ptr, out_ptr,
                            S, C, rows_per_chunk, n_chunks, n_parts, eps,
                            GAMMA_MODE: tl.constexpr, BLOCK_K: tl.constexpr,
                            BLOCK_C: tl.constexpr):
        # merges BLOCK_K chunk partials per step: mean = sum(n_k mean_k) / S,
        # then M2 = sum(M2_k + n_k (mean_k - mean)^2), the exact parallel form
        b = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc = tl.zeros([BLOCK_C], tl.float32)
        for k0 in range(0, n_chunks, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            kmask = ks < n_chunks
            nk = tl.where(kmask, tl.minimum(rows_per_chunk, S - ks * rows_per_chunk), 0)
            offs = (b * n_chunks + ks).to(tl.int64)[:, None] * C + cols[None, :]
            m = kmask[:, None] & cmask[None, :]
            mk = tl.load(part_ptr + offs, mask=m, other=0.0)
            acc += tl.sum(nk.to(tl.float32)[:, None] * mk, axis=0)
        mean = acc / S
        m2 = tl.zeros([BLOCK_C], tl.float32)
        for k0 in range(0, n_chunks, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            kmask = ks < n_chunks
            nk = tl.where(kmask, tl.minimum(rows_per_chunk, S - ks * rows_per_chunk), 0)
            offs = (b * n_chunks + ks).to(tl.int64)[:, None] * C + cols[None, :]
            m = kmask[:, None] & cmask[None, :]
            mk = tl.load(part_ptr + offs, mask=m, other=0.0)
            m2k = tl.load(part_ptr + n_parts * C + offs, mask=m, other=0.0)
            d = tl.where(m, mk - mean[None, :], 0.0)
            m2 += tl.sum(m2k + nk.to(tl.float32)[:, None] * d * d, axis=0)
        inv = 1.0 / tl.sqrt(tl.maximum(m2 / S, 0.0) + eps)
        if GAMMA_MODE == 0:
            scale = inv
            shift = -mean * inv
        else:
            row = 0
            if GAMMA_MODE == 2:
                row = tl.load(styles_ptr + b)
            g = tl.load(gamma_ptr + row * C + cols, mask=cmask, other=0.0).to(tl.float32)
            bt = tl.load(beta_ptr + row * C + cols, mask=cmask, other=0.0).to(tl.float32)
            scale = inv * g
            shift = bt - mean * scale
        out = out_ptr + b * C + cols
        tl.store(out, scale, mask=cmask)
        tl.store(out + tl.num_programs(0) * C, shift, mask=cmask)

    @triton.jit
    def miseg_k1_stats_merge(part_ptr, out_ptr, S, C, rows_per_chunk, n_chunks,
                             n_groups, n_parts, n_out, GROUP: tl.constexpr,
                             BLOCK_C: tl.constexpr):
        # merges GROUP consecutive chunk partials of one sample into one
        # partial of GROUP * rows_per_chunk rows, with the fold's formula
        pid = tl.program_id(0)                 # b * n_groups + g
        b = pid // n_groups
        g = pid % n_groups
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        ks = g * GROUP + tl.arange(0, GROUP)
        kmask = ks < n_chunks
        nk = tl.where(kmask, tl.minimum(rows_per_chunk, S - ks * rows_per_chunk),
                      0).to(tl.float32)
        offs = (b * n_chunks + ks).to(tl.int64)[:, None] * C + cols[None, :]
        m = kmask[:, None] & cmask[None, :]
        mk = tl.load(part_ptr + offs, mask=m, other=0.0)
        m2k = tl.load(part_ptr + n_parts * C + offs, mask=m, other=0.0)
        mean = tl.sum(nk[:, None] * mk, axis=0) / tl.sum(nk, axis=0)
        d = tl.where(m, mk - mean[None, :], 0.0)
        m2 = tl.sum(m2k + nk[:, None] * d * d, axis=0)
        out = pid.to(tl.int64) * C + cols
        tl.store(out_ptr + out, mean, mask=cmask)
        tl.store(out_ptr + n_out * C + out, m2, mask=cmask)

    @triton.jit
    def miseg_k2_apply(x_ptr, scale_ptr, shift_ptr, add_ptr, y_ptr, SC, C, slope,
                       HAS_ADD: tl.constexpr, HAS_SLOPE: tl.constexpr,
                       BLOCK: tl.constexpr):
        b = tl.program_id(1)
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < SC
        base = b.to(tl.int64) * SC
        ch = b * C + offs % C
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        s = tl.load(scale_ptr + ch, mask=mask, other=0.0)
        h = tl.load(shift_ptr + ch, mask=mask, other=0.0)
        y = x * s + h
        if HAS_ADD:
            y = y + tl.load(add_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        if HAS_SLOPE:
            y = tl.where(y >= 0, y, slope * y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def miseg_k3_apply2(x_ptr, sx_ptr, hx_ptr, r_ptr, sr_ptr, hr_ptr, y_ptr, SC,
                        C, slope, HAS_SLOPE: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(1)
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < SC
        base = b.to(tl.int64) * SC
        ch = b * C + offs % C
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        r = tl.load(r_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        yx = (x * tl.load(sx_ptr + ch, mask=mask, other=0.0)
              + tl.load(hx_ptr + ch, mask=mask, other=0.0))
        yr = (r * tl.load(sr_ptr + ch, mask=mask, other=0.0)
              + tl.load(hr_ptr + ch, mask=mask, other=0.0))
        y = yx + yr
        if HAS_SLOPE:
            y = tl.where(y >= 0, y, slope * y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return types.SimpleNamespace(
        stats_partial=miseg_k1_stats_partial, stats_merge=miseg_k1_stats_merge,
        stats_fold=miseg_k1_stats_fold, apply=miseg_k2_apply, apply2=miseg_k3_apply2)


def stats_grid(bsz: int, s: int, c: int, num_sms: int):
    """(block_c, rows_per_chunk, n_chunks) for K1's pass 1: narrow channel
    blocks when C is wide, and enough row chunks to give every SM a few
    programs."""
    block_c = min(64, max(16, 1 << (c - 1).bit_length()))
    max_chunks = math.ceil(s / _STATS_BLOCK_S)
    while block_c > 16 and bsz * math.ceil(c / block_c) * max_chunks < num_sms:
        block_c //= 2
    c_blocks = math.ceil(c / block_c)
    want = math.ceil(_PROGRAMS_PER_SM * num_sms / (bsz * c_blocks))
    rows = max(_STATS_BLOCK_S, math.ceil(s / max(want, 1)))
    rows = math.ceil(rows / _STATS_BLOCK_S) * _STATS_BLOCK_S
    return block_c, rows, math.ceil(s / rows)


def _check_cuda(x3, *others):
    if x3.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused norm takes float tensors, got {x3.dtype}")
    if not x3.is_contiguous():
        raise ValueError("fused norm kernels take a contiguous [B, S, C] tensor")
    for t in others:
        if t is not None and t.device != x3.device:
            raise ValueError("all operands must be on one device")


def _gamma_mode(gamma, beta, styles):
    """(mode, gamma, beta, styles) for the fold: 0 = no affine, 1 = `[C]`,
    2 = `[S, C]` banks with clamped int32 style ids."""
    if gamma is None:
        return 0, None, None, None
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if gamma.ndim == 1:
        return 1, gamma, beta, None
    # clamp here: an out-of-range id would index past the bank
    return 2, gamma, beta, styles.clamp(0, gamma.shape[0] - 1).to(torch.int32)


def fold_partials(part, s: int, rows: int, n_chunks: int, gamma=None,
                  beta=None, styles=None, *, eps: float = 1e-5):
    """K1's fold on the card: per-chunk (mean, M2) partials `f32 [2,
    B*n_chunks, C]` of `rows`-row chunks of S rows (only a sample's last
    chunk short) -> f32 (scale, shift) `[B, C]`, with gamma/beta as in
    `channel_scale_shift`.  Many partials (K4's 256-voxel bricks: 3456 per
    96^3 sample) are first merged in groups by parallel programs, since
    the fold walks a sample's partials in one program.  Part of the launch
    that wrote the partials: it counts nothing."""
    _, n_parts, c = part.shape
    bsz = n_parts // n_chunks
    mode, gamma, beta, styles = _gamma_mode(gamma, beta, styles)
    out = torch.empty((2, bsz, c), dtype=torch.float32, device=part.device)
    k = _kernels()
    with torch.cuda.device(part.device):
        while n_chunks > _MERGE_ABOVE:
            n_groups = math.ceil(n_chunks / _MERGE_GROUP)
            merged = torch.empty((2, bsz * n_groups, c), dtype=torch.float32,
                                 device=part.device)
            k.stats_merge[(bsz * n_groups, math.ceil(c / _FOLD_BLOCK_C))](
                part, merged, s, c, rows, n_chunks, n_groups, n_parts,
                bsz * n_groups, GROUP=_MERGE_GROUP, BLOCK_C=_FOLD_BLOCK_C,
                num_warps=4)
            part, rows, n_chunks, n_parts = (merged, rows * _MERGE_GROUP, n_groups,
                                             bsz * n_groups)
        k.stats_fold[(bsz, math.ceil(c / _FOLD_BLOCK_C))](
            part, gamma if mode else out, beta if mode else out,
            styles if mode == 2 else out, out, s, c, rows, n_chunks, n_parts,
            float(eps), GAMMA_MODE=mode, BLOCK_K=_FOLD_BLOCK_K,
            BLOCK_C=_FOLD_BLOCK_C, num_warps=4)
    return out[0], out[1]


def channel_scale_shift(x3, gamma=None, beta=None, styles=None, *,
                        eps: float = 1e-5):
    """K1: x3 `[B, S, C]` -> f32 (scale, shift) `[B, C]`.  gamma/beta:
    None, `[C]`, or `[num_styles, C]` banks gathered by `styles: int[B]`."""
    if gamma is not None and gamma.ndim == 2 and styles is None:
        raise ValueError("conditional banks need a styles vector")
    if x3.device.type == "cpu":
        return channel_scale_shift_plain(x3, gamma, beta, styles, eps=eps)
    if x3.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x3.device}")
    _check_cuda(x3, gamma, beta, styles)
    bsz, s, c = x3.shape
    num_sms = torch.cuda.get_device_properties(x3.device).multi_processor_count
    block_c, rows, n_chunks = stats_grid(bsz, s, c, num_sms)
    part = torch.empty((2, bsz * n_chunks, c), dtype=torch.float32, device=x3.device)
    with torch.cuda.device(x3.device):
        _kernels().stats_partial[(bsz * n_chunks, math.ceil(c / block_c))](
            x3, part, s, c, rows, n_chunks,
            BLOCK_S=_STATS_BLOCK_S, BLOCK_C=block_c, num_warps=4)
    scale, shift = fold_partials(part, s, rows, n_chunks, gamma, beta, styles,
                                 eps=eps)
    global stats_launches
    stats_launches += 1
    return scale, shift


def apply_scale_shift(x3, scale, shift, add3=None, *,
                      negative_slope: float | None = None):
    """K2: `leaky(x3 * scale + shift (+ add3))`, rounded once to x3's dtype."""
    if add3 is not None and add3.shape != x3.shape:
        raise ValueError(f"add shape {tuple(add3.shape)} != {tuple(x3.shape)}")
    if x3.device.type == "cpu":
        return apply_scale_shift_plain(x3, scale, shift, add3,
                                       negative_slope=negative_slope)
    if x3.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x3.device}")
    _check_cuda(x3, scale, shift, add3)
    if add3 is not None and not add3.is_contiguous():
        raise ValueError("add must be contiguous")
    bsz, s, c = x3.shape
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    y = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        _kernels().apply[(math.ceil(s * c / _APPLY_BLOCK), bsz)](
            x3, scale, shift, add3 if add3 is not None else x3, y, s * c, c,
            float(negative_slope or 0.0), HAS_ADD=add3 is not None,
            HAS_SLOPE=negative_slope is not None, BLOCK=_APPLY_BLOCK,
            num_warps=8)
    global apply_launches
    apply_launches += 1
    return y


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


def apply_norm2_act(x, sx, hx, res, sr, hr, *,
                    negative_slope: float | None = None):
    """K3: `leaky((x * sx + hx) + (res * sr + hr))` over `[B, *spatial, C]`
    with f32 columns `[B, C]`, rounded once to x's dtype — the UnetResBlock
    tail with both branches' instance norms folded into columns."""
    if res.shape != x.shape:
        raise ValueError(f"residual shape {tuple(res.shape)} != {tuple(x.shape)}")
    cols = (x.shape[0], x.shape[-1])
    if any(tuple(v.shape) != cols for v in (sx, hx, sr, hr)):
        raise ValueError(f"columns must be [B, C] = {list(cols)}")
    if x.device.type == "cpu":
        return apply_norm2_act_plain(x, sx, hx, res, sr, hr,
                                     negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x.device}")
    _check_cuda(x, sx, hx, res, sr, hr)
    if res.dtype != x.dtype or not res.is_contiguous():
        raise ValueError("the residual must be contiguous and of x's dtype")
    bsz, c = cols
    sc = x.numel() // bsz
    sx, hx, sr, hr = (v.float().contiguous() for v in (sx, hx, sr, hr))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _kernels().apply2[(math.ceil(sc / _APPLY_BLOCK), bsz)](
            x, sx, hx, res, sr, hr, y, sc, c, float(negative_slope or 0.0),
            HAS_SLOPE=negative_slope is not None, BLOCK=_APPLY_BLOCK, num_warps=8)
    global apply2_launches
    apply2_launches += 1
    return y
