"""Card-only tests: each hand-written kernel against its plain version on
the same CUDA tensors.  Marked `cuda`; they skip where no card is present.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 results within 1e-5 relative to the output's scale
(summation order and FMA contraction differ); bf16 (and f16) results
within one bf16 (f16) ulp of the largest output (both sides round the
same f32 value once, so a last-bit difference can flip the rounding).
"""

import re

import numpy as np
import pytest
import torch

from miseg_tpu_torch.ops.kernels import counters, fused_conv, fused_norm, window_attention as wa
from miseg_tpu_torch.ops.window import window_region_ids

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module", autouse=True)
def kernels_loaded():
    """Where a card is present, build and load every kernel library before
    the first test, so that no test pays for a build and every kernel's
    module is known to the profiler before any profiled test runs."""
    if torch.cuda.is_available():
        from miseg_tpu_torch.ops.kernels import build
        build.build_all()
        fused_conv._entry()
        fused_norm._k1()
        fused_norm._k23()
        wa._lib()
    yield


def _tol(ref: torch.Tensor, dtype) -> float:
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    if dtype == torch.float16:   # one f16 ulp (10 fraction bits)
        return scale * 2.0 ** -10 + 1e-6
    return scale * 2.0 ** -7 + 1e-6 if dtype == torch.bfloat16 else 1e-5 * (1.0 + scale)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _device_kernels(run, ok, attempts: int = 3) -> list[str]:
    """The names of the device kernels torch.profiler records while `run()`
    runs, in launch order, from the first of `attempts` sessions whose
    names satisfy `ok(names)`, else from the last.  The profiler misses
    kernels launched right after a session starts (and now and then a
    whole session's), so each session first runs ATen's `spin_kernel`
    (`torch.cuda._sleep`), left out of the names; a kernel that launches
    wrongly fails every session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]
        if ok(names):
            break
    return names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 48), (1, 48, 48, 48, 48),
                                   (1, 3, 3, 3, 3072), (3, 4, 4, 4, 100),
                                   (1, 48, 48, 48, 32), (1, 12, 12, 12, 128)])
@pytest.mark.parametrize("affine", ["none", "channel", "bank"])
def test_k1_k2_match_plain(dev, gen, shape, dtype, affine):
    b, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dev, dtype)
    add = torch.randn(shape, generator=gen).to(dev, dtype)
    gamma = beta = styles = None
    if affine == "channel":
        gamma, beta = torch.randn(c, generator=gen).to(dev), torch.randn(c, generator=gen).to(dev)
    elif affine == "bank":
        gamma = torch.randn((2, c), generator=gen).to(dev)
        beta = torch.randn((2, c), generator=gen).to(dev)
        styles = torch.tensor([5, -1, 1][:b], dtype=torch.int32, device=dev)  # clamps
    x3 = x.reshape(b, -1, c)
    scale, shift = fused_norm.channel_scale_shift(x3, gamma, beta, styles)
    rs, rh = fused_norm.channel_scale_shift_plain(x3, gamma, beta, styles)
    assert _err(scale, rs) <= 1e-5 * (1 + float(rs.abs().max()))
    assert _err(shift, rh) <= 1e-5 * (1 + float(rh.abs().max()))
    for a3, slope in [(None, None), (add.reshape(x3.shape), 0.01)]:
        y = fused_norm.apply_scale_shift(x3, rs, rh, a3, negative_slope=slope)
        ref = fused_norm.apply_scale_shift_plain(x3, rs, rh, a3, negative_slope=slope)
        assert y.dtype == dtype
        assert _err(y, ref) <= _tol(ref, dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_act_takes_2d_callers(dev, gen, dtype):
    """A 2-D norm's `[B, H, W, C]` through `instance_norm_act` (K1 + K2 on
    `[B, H*W, C]`, with banks, an add and the leaky relu) against the same
    call on the CPU, which runs the plain versions."""
    x = (torch.randn((2, 96, 96, 48), generator=gen) * 2 + 0.5).to(dtype)
    add = torch.randn(x.shape, generator=gen).to(dtype)
    gamma, beta = torch.randn((2, 48), generator=gen), torch.randn((2, 48), generator=gen)
    styles = torch.tensor([1, 0], dtype=torch.int32)
    ref = fused_norm.instance_norm_act(x, gamma, beta, styles, negative_slope=0.01, add=add)
    k1, k2 = fused_norm.stats_launches, fused_norm.apply_launches
    got = fused_norm.instance_norm_act(x.to(dev), gamma.to(dev), beta.to(dev), styles.to(dev),
                                       negative_slope=0.01, add=add.to(dev))
    assert (fused_norm.stats_launches, fused_norm.apply_launches) == (k1 + 1, k2 + 1)
    assert got.shape == x.shape and got.dtype == dtype
    assert _err(got.cpu(), ref) <= _tol(ref, dtype)


def test_k1_k2_count_launches(dev):
    x = torch.randn((1, 4, 4, 4, 8), device=dev)
    fused_norm.stats_launches = fused_norm.apply_launches = 0
    fused_norm.instance_norm_act(x)
    assert (fused_norm.stats_launches, fused_norm.apply_launches) == (1, 1)


def _rel(a, b) -> float:
    return _err(a, b) / (1 + float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_k1_small_variance_channel(dev, gen, dtype, aligned):
    """A channel with var << mean^2 (ROADMAP W1) on the card, with 16-byte
    loads and, from an x that starts 2 bytes past a 16-byte boundary, with
    scalar ones: the columns within 1e-5 relative of the plain version."""
    shape = (1, 32 * 32 * 32, 48)
    base = (torch.randn(shape, generator=gen)).to(dev, dtype)
    base[..., 3] = 0.3 + 0.01 * base[..., 3]
    if aligned:
        x3 = base
    else:
        buf = torch.empty(base.numel() + 8, dtype=dtype, device=dev)
        x3 = buf[1:1 + base.numel()].view(shape)
        x3.copy_(base)
        assert x3.data_ptr() % 16 and x3.is_contiguous()
    got = fused_norm.channel_scale_shift(x3)
    want = fused_norm.channel_scale_shift_plain(x3)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def test_k1_repeats_bit_identically(dev, gen):
    """Both entry points, each with a cross-CTA merge, give the same bits
    twice: the merge order does not depend on which CTA arrives last."""
    x3 = (torch.randn((1, 48 ** 3, 48), generator=gen) * 2 + 0.5).to(dev, torch.bfloat16)
    gamma = torch.randn((2, 48), generator=gen).to(dev)
    beta = torch.randn((2, 48), generator=gen).to(dev)
    styles = torch.tensor([1], dtype=torch.int32, device=dev)
    _, _, _, n_chunks = fused_norm.stats_grid(1, 48 ** 3, 48, _sms(dev), 8)
    assert n_chunks > 1
    first = fused_norm.channel_scale_shift(x3, gamma, beta, styles)
    second = fused_norm.channel_scale_shift(x3, gamma, beta, styles)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    part = _partials(x3, 256)
    assert fused_norm.fold_grid(part.shape[1], 48)[1] > 1
    first = fused_norm.fold_partials(part, 48 ** 3, 256, part.shape[1], gamma, beta, styles)
    second = fused_norm.fold_partials(part, 48 ** 3, 256, part.shape[1], gamma, beta, styles)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _partials(x3, rows):
    """Per-tile (mean, M2) `f32 [2, B * n_tiles, C]` of x3 `[B, S, C]` in
    tiles of `rows` rows (a sample's last tile short), as K4 writes them."""
    b, s, c = x3.shape
    n = -(-s // rows)
    xf = torch.nn.functional.pad(x3.float(), (0, 0, 0, n * rows - s)).reshape(b, n, rows, c)
    counts = (s - torch.arange(n, device=x3.device) * rows).clamp(max=rows).float()
    valid = (torch.arange(rows, device=x3.device)[None, :] < counts[:, None]).float()
    mean = (xf * valid[None, :, :, None]).sum(2) / counts[None, :, None]
    m2 = (((xf - mean[:, :, None]) * valid[None, :, :, None]) ** 2).sum(2)
    return torch.stack([mean.reshape(b * n, c), m2.reshape(b * n, c)]).contiguous()


# (x shape [B, S, C], tile rows): K4's brick partials at 96^3 (3456 a
# sample) and 48^3 (432), its 24^3 tiles (216), a short last tile over
# two samples, one tile, and wide channels (several channel blocks)
_FOLDS = {
    "96cube_bricks": ((1, 96 ** 3, 48), 256),
    "48cube_bricks": ((1, 48 ** 3, 48), 256),
    "24cube_tiles": ((1, 24 ** 3, 96), 64),
    "b2_short_last": ((2, 1000, 48), 64),
    "one_tile": ((2, 27, 768), 27),
    "wide_c": ((1, 12 ** 3, 768), 64),
}


@pytest.mark.parametrize("affine", ["none", "channel", "bank"])
@pytest.mark.parametrize("case", sorted(_FOLDS))
def test_k1_fold_matches_plain(dev, gen, case, affine):
    shape, rows = _FOLDS[case]
    b, s, c = shape
    x3 = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dev)
    part = _partials(x3, rows)
    gamma = beta = styles = None
    if affine == "channel":
        gamma, beta = torch.randn(c, generator=gen).to(dev), torch.randn(c, generator=gen).to(dev)
    elif affine == "bank":
        gamma = torch.randn((2, c), generator=gen).to(dev, torch.bfloat16)
        beta = torch.randn((2, c), generator=gen).to(dev, torch.bfloat16)
        styles = torch.tensor([5, -1][:b], dtype=torch.int32, device=dev)   # clamps
    before = fused_norm.fold_launches
    got = fused_norm.fold_partials(part, s, rows, part.shape[1] // b, gamma, beta, styles)
    assert fused_norm.fold_launches == before + 1
    want = fused_norm.fold_partials_plain(part, s, rows, part.shape[1] // b, gamma, beta, styles)
    for a, ref in zip(got, want):
        assert _rel(a, ref) <= 1e-5


def test_k1_each_call_is_one_kernel(dev, gen):
    """Under torch.profiler, every channel_scale_shift and every
    fold_partials call is exactly one device kernel: in order, the
    statistics kernel (a sample of many chunks, then wide channels over
    short rows) and the fold."""
    x3 = torch.randn((1, 48 ** 3, 48), generator=gen).to(dev, torch.bfloat16)
    wide = torch.randn((1, 27, 3072), generator=gen).to(dev, torch.bfloat16)
    gamma = torch.randn((2, 48), generator=gen).to(dev, torch.bfloat16)
    beta = torch.randn((2, 48), generator=gen).to(dev, torch.bfloat16)
    styles = torch.tensor([1], dtype=torch.int32, device=dev)
    part = _partials(x3, 256)

    def calls():
        fused_norm.channel_scale_shift(x3, gamma, beta, styles)
        fused_norm.channel_scale_shift(wide)
        fused_norm.fold_partials(part, 48 ** 3, 256, part.shape[1], gamma, beta, styles)
        torch.cuda.synchronize()

    def ok(names):
        return (len(names) == 3 and "miseg_k1_stats<" in names[0]
                and "miseg_k1_stats<" in names[1] and "miseg_k1_fold" in names[2])

    calls()   # builds and warms up
    names = _device_kernels(calls, ok)
    assert ok(names), names


def test_k1_shapes_in_turn(dev, gen):
    """Two shapes whose samples span several chunks, called in turn twice on
    one stream: the same results each time, and every counter back at 0."""
    xs = [(torch.randn(shape, generator=gen) + 0.5).to(dev, torch.bfloat16)
          for shape in [(1, 48 ** 3, 48), (2, 24 ** 3, 96)]]
    runs = [[fused_norm.channel_scale_shift(x) for x in xs] for _ in range(2)]
    for first, second in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    for x, (sc, sh) in zip(xs, runs[0]):
        rs, rh = fused_norm.channel_scale_shift_plain(x)
        assert _rel(sc, rs) <= 1e-5 and _rel(sh, rh) <= 1e-5
    torch.cuda.synchronize()
    assert counters._buffers
    assert all(int(torch.count_nonzero(c)) == 0 for c in counters._buffers.values())


# (window batch, N, channels, heads, mask geometry or None).  The bf16
# kernel takes query blocks of 64 rows (N = 343, 216, 100, 27 and 8 end
# inside one) and zero-pads head dims to 16, 32, 48 or 64 (hd 6, 24, 40)
_ATTN = {
    "stage1_ids": (343, 343, 48, 3, ((49, 49, 49), (7, 7, 7), (3, 3, 3))),
    "stage2": (64, 343, 96, 6, None),
    "stage3_ids": (16, 343, 192, 12, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "stage4_clipped": (1, 216, 384, 24, None),
    "n216_ids": (16, 216, 64, 4, ((12, 12, 12), (6, 6, 6), (3, 3, 3))),
    "hd6_n27_ids": (16, 27, 12, 2, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd24_n100": (3, 100, 72, 3, None),
    "hd40_n64": (5, 64, 80, 2, None),
    "hd64_n8": (4, 8, 128, 2, None),
    # the hyper-parameter search's swin widths (fs 12/24/36, heads 2/3/4):
    # head dims 3, 4, 9, 12 and 18 (9 and 18 on the scalar load path, 18
    # padded to 32), each over 343-token windows with ids and over 27
    "hd3_ids": (16, 343, 12, 4, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "hd3_n27": (16, 27, 12, 4, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd4_ids": (16, 343, 12, 3, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "hd4_n27": (16, 27, 12, 3, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd9_ids": (16, 343, 36, 4, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "hd9_n27": (16, 27, 36, 4, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd12_ids": (16, 343, 36, 3, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "hd12_n27": (16, 27, 24, 2, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    "hd18_ids": (16, 343, 36, 2, ((14, 14, 14), (7, 7, 7), (3, 3, 3))),
    "hd18_n27": (16, 27, 36, 2, ((6, 6, 6), (3, 3, 3), (1, 1, 1))),
    # 2-D swin (spatial_dims=2): stage 1 of a 96x96 slice, 49 windows of
    # 7x7 (N = 49, not a multiple of 16) at head dim 16, with and without
    # the shifted window's ids; stage 4, one 6x6 window clipped from 7x7
    "2d_n49_ids": (49, 49, 48, 3, ((49, 49), (7, 7), (3, 3))),
    "2d_n49": (49, 49, 48, 3, None),
    "2d_n36": (1, 36, 384, 24, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_ATTN))
def test_k5_matches_plain(dev, gen, case, dtype):
    bw, n, c, heads, geom = _ATTN[case]
    qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=gen).to(dev)
    ids = None if geom is None else window_region_ids(*geom, device=dev)
    before = wa.launches
    out = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
    assert wa.launches == before + 1
    ref = wa.window_attention_plain(q, k, v, bias, ids, num_heads=heads)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (bw, n, c)
    assert _err(out, ref) <= _tol(ref, dtype)


def test_k5_short_last_window_group(dev, gen):
    """Stage 1: a CTA walks a group of windows, and the last group of the
    343 is short."""
    bw, n, c, heads, geom = _ATTN["stage1_ids"]
    group = wa.window_group(bw, n, heads, dev)
    assert 1 < group < bw and bw % group
    qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=gen).to(dev)
    ids = window_region_ids(*geom, device=dev)
    out = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
    ref = wa.window_attention_plain(q, k, v, bias, ids, num_heads=heads)
    last = slice(bw - bw % group, bw)
    assert _err(out[last], ref[last]) <= _tol(ref, torch.bfloat16)
    assert _err(out, ref) <= _tol(ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_repeats_bit_identically(dev, gen, dtype):
    bw, n, c, heads, geom = _ATTN["stage3_ids"]
    qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=gen).to(dev)
    ids = window_region_ids(*geom, device=dev)
    first = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
    second = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
    assert torch.equal(first, second)


def test_k5_rejects_oversize(dev):
    q = torch.zeros((1, 344, 16), device=dev)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros((1, 344, 344), device=dev), num_heads=1)
    q = torch.zeros((1, 8, 65), device=dev)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros((1, 8, 8), device=dev), num_heads=1)


# K4 cases: (x shape, Cout); the flagship's main-path channel pairs at cut
# spatial sizes, encoder1's Cin = 1 (on a volume no brick divides, and on
# the Cin = 1 brick path: 8x8x32, two samples, Cout 16), encoder10's 768 ->
# 768 at 3^3, a
# generic odd one, X % 16 == 0 shapes that no brick divides and that hold
# more than 256 voxels (the FMA path in bf16 too: tiles spanning several
# x-rows, a short last tile), brick-path shapes (the 48^3 level, 16x16x32
# at 48->48 and 96->48, one brick whose faces are all halo, and 32->64),
# and the coarse path at every (shape, Cin, Cout) of the flagship's 24^3,
# 12^3, 6^3 and 3^3 convs (3^3 is 768_to768), plus 12^3 at batch 2; and
# C-UNETR's (fs 16): the brick path at 16 and 32 output channels (one
# and two 16-column fragments, 16- and 32-channel chunks), the coarse path
# at every (shape, Cin, Cout) of its 24^3 and 12^3 convs
_CONV = {
    "cin1_to48": ((1, 7, 9, 11, 1), 48),
    "cin1_brick_to48": ((1, 8, 8, 32, 1), 48),
    "cin1_brick_to48_b2": ((2, 16, 16, 16, 1), 48),
    "cin1_brick_to16": ((1, 8, 8, 16, 1), 16),
    "48_to48": ((1, 24, 24, 24, 48), 48),
    "96_to48_b2": ((2, 16, 16, 16, 96), 48),
    "768_to768": ((1, 3, 3, 3, 768), 768),
    "odd_5_to7": ((2, 6, 8, 8, 5), 7),
    "band_x48_short": ((1, 4, 5, 48, 48), 48),
    "band_x16_b2": ((2, 5, 4, 16, 32), 64),
    "brick_48cube": ((1, 48, 48, 48, 48), 48),
    "brick_48_to48": ((1, 16, 16, 32, 48), 48),
    "brick_96_to48_b2": ((2, 16, 16, 32, 96), 48),
    "brick_one": ((1, 4, 4, 16, 48), 48),
    "brick_32_to64": ((1, 8, 4, 16, 32), 64),
    "coarse_24_96_to96": ((1, 24, 24, 24, 96), 96),
    "coarse_24_192_to96": ((1, 24, 24, 24, 192), 96),
    "coarse_12_192_to192": ((1, 12, 12, 12, 192), 192),
    "coarse_12_384_to192": ((1, 12, 12, 12, 384), 192),
    "coarse_6_768_to384": ((1, 6, 6, 6, 768), 384),
    "coarse_6_384_to384": ((1, 6, 6, 6, 384), 384),
    "coarse_12_192_to192_b2": ((2, 12, 12, 12, 192), 192),
    "brick_unetr_16_to16": ((1, 8, 8, 32, 16), 16),
    "brick_unetr_32_to16_b2": ((2, 8, 8, 16, 32), 16),
    "brick_unetr_32_to32": ((1, 8, 8, 32, 32), 32),
    "brick_unetr_64_to32": ((1, 8, 8, 16, 64), 32),
    "coarse_unetr_24_32_to32": ((1, 24, 24, 24, 32), 32),
    "coarse_unetr_24_64_to64": ((1, 24, 24, 24, 64), 64),
    "coarse_unetr_24_128_to64": ((1, 24, 24, 24, 128), 64),
    "coarse_unetr_12_256_to128": ((1, 12, 12, 12, 256), 128),
    "coarse_unetr_12_128_to128": ((1, 12, 12, 12, 128), 128),
}


def _conv_operands(gen, dev, dtype, shape, cout, prologue):
    b, cin = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen) / (27 * cin) ** 0.5).to(dev, dtype)
    kw = {}
    if prologue != "none":   # a per-sample bank row, as a norm's columns
        kw = dict(scale=(1 + 0.3 * torch.randn((b, cin), generator=gen)).to(dev),
                  shift=(0.3 * torch.randn((b, cin), generator=gen)).to(dev))
    if prologue == "affine_leaky":
        kw["slope"] = 0.01
    gamma = (1 + 0.2 * torch.randn((2, cout), generator=gen)).to(dev, dtype)
    beta = (0.2 * torch.randn((2, cout), generator=gen)).to(dev, dtype)
    styles = torch.tensor([1, 0][:b], dtype=torch.int32, device=dev)
    return x, w, dict(kw, gamma=gamma, beta=beta, styles=styles)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_CONV))
@pytest.mark.parametrize("prologue", ["none", "affine", "affine_leaky"])
def test_k4_matches_plain(dev, gen, case, dtype, prologue):
    """y at the file's tolerances; the columns against the plain fold of
    the kernel's OWN y at 1e-5 relative, which isolates the epilogue's
    statistics from the conv's rounding."""
    shape, cout = _CONV[case]
    x, w, kw = _conv_operands(gen, dev, dtype, shape, cout, prologue)
    before = fused_conv.launches
    y, sc, sh = fused_conv.conv3_norm_columns(x, w, **kw)
    assert fused_conv.launches == before + 1
    ref = fused_conv.conv3_norm_columns_plain(x, w, **kw)[0]
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (*shape[:-1], cout)
    assert _err(y, ref) <= _tol(ref, dtype)
    rs, rh = fused_norm.channel_scale_shift_plain(
        y.reshape(shape[0], -1, cout), kw["gamma"], kw["beta"], kw["styles"])
    assert _err(sc, rs) <= 1e-5 * (1 + float(rs.abs().max()))
    assert _err(sh, rh) <= 1e-5 * (1 + float(rh.abs().max()))


def test_k4_takes_bricks_where_they_divide(dev):
    """bf16 statistics tiles are 4x4x16 bricks where they divide the volume
    (and the channels suit the tensor cores: Cin and Cout multiples of 4,
    padded to 16 in the kernel, or Cin = 1), else 4x4x4 bricks where those
    divide it, else the whole sample where it holds at most 256 voxels,
    else 128 voxels; f32 runs on the CUDA cores in 128-voxel tiles."""
    tile_voxels = fused_conv._entry()[2]
    for case, (shape, cout) in _CONV.items():
        _, z, y, x, cin = shape
        tc = (cin % 4 == 0 or cin == 1) and cout % 4 == 0
        brick = tc and z % 4 == 0 and y % 4 == 0 and x % 16 == 0
        assert brick == (case.startswith(("brick", "cin1_brick")) or case == "96_to48_b2"), case
        tc = tc and cin != 1   # the coarse path takes Cin % 16 == 0 only
        if brick:
            want = 256
        elif tc and z % 4 == 0 and y % 4 == 0 and x % 4 == 0:
            want = 64
        elif tc and z * y * x <= 256:
            want = z * y * x
        else:
            want = 128
        coarse = want not in (256, 128)
        assert coarse == (case.startswith("coarse") or case in ("48_to48", "768_to768")), case
        assert tile_voxels(z, y, x, cin, cout, 1) == want, case
        assert tile_voxels(z, y, x, cin, cout, 0) == 128, case


def _coarse_splits(shape, cout) -> int:
    b, z, y, x, cin = shape
    return fused_conv._entry()[1](b, z, y, x, cin, cout, 1)


@pytest.mark.parametrize("shape,cout", [((1, 16, 16, 32, 48), 48), ((1, 6, 6, 6, 384), 384),
                                        ((2, 16, 16, 16, 1), 48)])
def test_k4_repeats_bit_identically(dev, gen, shape, cout):
    """A brick-path shape, a coarse one that splits K (its arrival counters
    are back at 0 after each call, so the repeat is the same), and a Cin = 1
    brick-path one."""
    if shape[1] == 6:
        assert _coarse_splits(shape, cout) > 1
    x, w, kw = _conv_operands(gen, dev, torch.bfloat16, shape, cout, "affine_leaky")
    first = fused_conv.conv3_norm_columns(x, w, **kw)
    second = fused_conv.conv3_norm_columns(x, w, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_k4_split_shapes_in_turn(dev, gen):
    """Two coarse shapes that split K differently, called in turn twice,
    give the same results each time and leave every counter at 0."""
    cases = [((1, 12, 12, 12, 192), 192), ((1, 3, 3, 3, 768), 768)]
    assert all(_coarse_splits(*c) > 1 for c in cases)
    operands = [_conv_operands(gen, dev, torch.bfloat16, s, c, "affine_leaky")
                for s, c in cases]
    runs = [[fused_conv.conv3_norm_columns(x, w, **kw) for x, w, kw in operands]
            for _ in range(2)]
    for first, second in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    torch.cuda.synchronize()
    assert counters._buffers
    assert all(int(torch.count_nonzero(c)) == 0 for c in counters._buffers.values())


def _k4_call_kernels(x, w, kw, kernel: str) -> list[str]:
    """The `miseg_k4_` device kernels of one K4 call after a warm-up, from
    a profiler session that saw exactly one, `kernel`, if any did."""
    def ok(names):
        return len(names) == 1 and kernel in names[0]

    fused_conv.conv3_norm_columns(x, w, **kw)   # builds and warms up
    torch.cuda.synchronize()
    names = _device_kernels(lambda: fused_conv.conv3_norm_columns(x, w, **kw),
                            lambda names: ok([n for n in names if "miseg_k4_" in n]))
    return [n for n in names if "miseg_k4_" in n]


@pytest.mark.parametrize("shape,cout", [((1, 24, 24, 24, 96), 96), ((1, 3, 3, 3, 768), 768)])
def test_k4_coarse_call_is_one_kernel(dev, gen, shape, cout):
    """A bf16 coarse call, split or not, is one K4 device kernel (the
    coarse kernel) besides its fold: no second reduce launch."""
    x, w, kw = _conv_operands(gen, dev, torch.bfloat16, shape, cout, "affine_leaky")
    names = _k4_call_kernels(x, w, kw, "miseg_k4_conv_coarse")
    assert len(names) == 1 and "miseg_k4_conv_coarse" in names[0], names


@pytest.mark.parametrize("case,dtype,kernel", [
    ("cin1_brick_to48", torch.bfloat16, "miseg_k4_conv_cin1"),
    ("cin1_brick_to48_b2", torch.bfloat16, "miseg_k4_conv_cin1"),
    ("cin1_to48", torch.bfloat16, "miseg_k4_conv_fma"),       # no brick divides 7x9x11
    ("cin1_brick_to48", torch.float32, "miseg_k4_conv_fma"),  # f32 never takes TF32
])
def test_k4_cin1_call_is_one_kernel(dev, gen, case, dtype, kernel):
    """A Cin = 1 call is one K4 device kernel besides K1's fold: the Cin = 1
    tensor-core kernel for bf16 volumes that bricks divide, else the FMA
    kernel (with no split-K reduce)."""
    shape, cout = _CONV[case]
    x, w, kw = _conv_operands(gen, dev, dtype, shape, cout, "none")
    names = _k4_call_kernels(x, w, kw, kernel)
    assert len(names) == 1 and kernel in names[0], names


# K4 at the hyper-parameter search's swin widths (fs 12/24/36: channels
# 12, 24, 36 and 72 are not multiples of 16), at cut spatial sizes and at
# the widths' own 24^3 and 12^3, with the decoder's mixed widths (the
# concatenation before decoder1..3: 24->12, 48->24, 144->72), and an odd
# width no tensor-core path takes: (x shape, Cout, bf16 kernel).  In bf16
# the tensor-core kernels take them, the channels padded to 16 inside the
# kernel; f32 runs the FMA kernel (never TF32), with its split-K reduce
# where the call splits K
_CONV_SEARCH = {
    "fs12_12_to12": ((1, 16, 16, 32, 12), 12, "miseg_k4_conv_brick"),
    "fs36_36_to36": ((1, 16, 16, 32, 36), 36, "miseg_k4_conv_brick"),
    "fs12_cin1_to12": ((1, 8, 8, 32, 1), 12, "miseg_k4_conv_cin1"),
    "fs36_cin1_to36": ((1, 8, 8, 32, 1), 36, "miseg_k4_conv_cin1"),
    "fs36_72_to72": ((1, 12, 12, 12, 72), 72, "miseg_k4_conv_coarse"),
    "fs24_24_to24": ((1, 24, 24, 24, 24), 24, "miseg_k4_conv_coarse"),
    "fs12_24_to12": ((1, 16, 16, 32, 24), 12, "miseg_k4_conv_brick"),
    "fs24_48_to24": ((1, 16, 16, 32, 48), 24, "miseg_k4_conv_brick"),
    "fs36_144_to72": ((1, 24, 24, 24, 144), 72, "miseg_k4_conv_coarse"),
    "fs36_72_to36_b2": ((2, 8, 8, 16, 72), 36, "miseg_k4_conv_brick"),
    "fs12_whole_3cube_12_to12": ((1, 3, 3, 3, 12), 12, "miseg_k4_conv_coarse"),
    "odd_5_to7": ((2, 6, 8, 8, 5), 7, "miseg_k4_conv_fma"),
}


def _fma_block(cout: int) -> int:
    """The FMA kernel's column block: the least of 16, 32 and 64 that
    covers Cout, else 64."""
    return next((bn for bn in (16, 32) if cout <= bn), 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_CONV_SEARCH))
def test_k4_search_space_widths_take_tensor_cores(dev, gen, case, dtype):
    """y and the columns as `test_k4_matches_plain` holds them (with the
    prologue, but at Cin = 1), a repeat bit-identical, and the call's K4
    device kernels: in bf16 the tensor-core kernel by name (the FMA kernel
    for the odd width), in f32 the FMA kernel with a column block of the
    least of 16, 32 and 64 that covers Cout, then the split-K reduce on the
    same block when the planner splits K."""
    shape, cout, bf16_kernel = _CONV_SEARCH[case]
    b, z, y_, x_, cin = shape
    x, w, kw = _conv_operands(gen, dev, dtype, shape, cout,
                              "none" if cin == 1 else "affine_leaky")
    y, sc, sh = fused_conv.conv3_norm_columns(x, w, **kw)
    ref = fused_conv.conv3_norm_columns_plain(x, w, **kw)[0]
    torch.cuda.synchronize()
    assert y.shape == (*shape[:-1], cout)
    assert _err(y, ref) <= _tol(ref, dtype)
    rs, rh = fused_norm.channel_scale_shift_plain(
        y.reshape(b, -1, cout), kw["gamma"], kw["beta"], kw["styles"])
    assert _err(sc, rs) <= 1e-5 * (1 + float(rs.abs().max()))
    assert _err(sh, rh) <= 1e-5 * (1 + float(rh.abs().max()))
    again = fused_conv.conv3_norm_columns(x, w, **kw)
    assert all(torch.equal(a, c) for a, c in zip((y, sc, sh), again))
    code = 1 if dtype == torch.bfloat16 else 0
    kernel = bf16_kernel if dtype == torch.bfloat16 else "miseg_k4_conv_fma"
    want = [kernel]
    if kernel == "miseg_k4_conv_fma":
        splits = fused_conv._entry()[1](b, z, y_, x_, cin, cout, code)
        want += ["miseg_k4_splitk_reduce"] * (splits > 1)

    def ok(names):
        return len(names) == len(want) and all(k in n for k, n in zip(want, names))

    names = [n for n in _device_kernels(
        lambda: fused_conv.conv3_norm_columns(x, w, **kw),
        lambda names: ok([n for n in names if "miseg_k4_" in n])) if "miseg_k4_" in n]
    assert ok(names), (names, want)
    if kernel == "miseg_k4_conv_fma":   # the template's column block
        blocks = {int(m) for n in names for m in re.findall(r"miseg_k4_\w+<[^,]+, (\d+)>", n)}
        assert blocks == {_fma_block(cout)}, names


# every distinct K4 geometry of the flagship's 96^3 window (fs 48): (x
# shape, Cout, kernel).  They keep the kernels and instances they had
# before the padded widths (no padding: the halo copy template's last
# argument is 0 on the brick and coarse kernels)
_FLAGSHIP_CONVS = [
    ((1, 96, 96, 96, 1), 48, "miseg_k4_conv_cin1<3>"),
    ((1, 96, 96, 96, 48), 48, "miseg_k4_conv_brick<3, 48, 0>"),
    ((1, 96, 96, 96, 96), 48, "miseg_k4_conv_brick<3, 48, 0>"),
    ((1, 48, 48, 48, 48), 48, "miseg_k4_conv_brick<3, 48, 0>"),
    ((1, 48, 48, 48, 96), 48, "miseg_k4_conv_brick<3, 48, 0>"),
    ((1, 24, 24, 24, 96), 96, "miseg_k4_conv_coarse<3, 32, 2, 0>"),
    ((1, 24, 24, 24, 192), 96, "miseg_k4_conv_coarse<3, 32, 2, 0>"),
    ((1, 12, 12, 12, 192), 192, "miseg_k4_conv_coarse<3, 32, 2, 0>"),
    ((1, 12, 12, 12, 384), 192, "miseg_k4_conv_coarse<3, 32, 2, 0>"),
    ((1, 6, 6, 6, 768), 384, "miseg_k4_conv_coarse<4, 32, 1, 0>"),
    ((1, 6, 6, 6, 384), 384, "miseg_k4_conv_coarse<4, 32, 1, 0>"),
    ((1, 3, 3, 3, 768), 768, "miseg_k4_conv_coarse<4, 32, 2, 0>"),
]


@pytest.mark.parametrize("i", range(len(_FLAGSHIP_CONVS)))
def test_k4_flagship_shapes_keep_their_kernels(dev, gen, i):
    """A bf16 call at each of the flagship's conv shapes launches the
    kernel instance it launched before the search widths were padded onto
    the tensor cores, and matches the plain version."""
    shape, cout, kernel = _FLAGSHIP_CONVS[i]
    x, w, kw = _conv_operands(gen, dev, torch.bfloat16, shape, cout,
                              "none" if shape[-1] == 1 else "affine_leaky")
    y = fused_conv.conv3_norm_columns(x, w, **kw)[0]
    ref = fused_conv.conv3_norm_columns_plain(x, w, **kw)[0]
    torch.cuda.synchronize()
    assert _err(y, ref) <= _tol(ref, torch.bfloat16)
    names = _k4_call_kernels(x, w, kw, kernel)
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_CONV))
def test_k3_matches_plain(dev, gen, case, dtype):
    shape, _ = _CONV[case]
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=gen).to(dev, dtype)
    res = torch.randn(shape, generator=gen).to(dev, dtype)
    cols = [torch.randn((b, c), generator=gen).to(dev) for _ in range(4)]
    for slope in (None, 0.01):
        before = fused_norm.apply2_launches
        y = fused_norm.apply_norm2_act(x, cols[0], cols[1], res, cols[2], cols[3],
                                       negative_slope=slope)
        assert fused_norm.apply2_launches == before + 1
        ref = fused_norm.apply_norm2_act_plain(x, cols[0], cols[1], res, cols[2],
                                               cols[3], negative_slope=slope)
        torch.cuda.synchronize()
        assert y.dtype == dtype
        assert _err(y, ref) <= _tol(ref, dtype)


# K2's shapes on a 96^3 window: the unfused path's 96^3 x 48, then every
# distinct shape of the served path (swin-block, patch-merging and proj_out
# norms, and the identity tails' adds at 48^3, 24^3, 12^3 and 3^3), then
# the residual UNets' (C-UNet's top `up` at 96^3 x 6, which no vector
# width divides; UNetVanilla's widest levels)
_K2_SHAPES = [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 24 ** 3, 384), (1, 24 ** 3, 96),
              (1, 12 ** 3, 768), (1, 12 ** 3, 192), (1, 6 ** 3, 1536), (1, 6 ** 3, 384),
              (1, 27, 3072), (1, 27, 768), (1, 96 ** 3, 6), (1, 48 ** 3, 64),
              (1, 12 ** 3, 512), (1, 12 ** 3, 256)]
# K3's: every projected-residual tail of the window, and 3^3 x 768 (off
# the served path, whose encoder10 tail is K2's add mode: the smallest
# tensor K3 is held at)
_K3_SHAPES = [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 24 ** 3, 96), (1, 12 ** 3, 192),
              (1, 6 ** 3, 384), (1, 27, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 96 ** 3, 6), (1, 12 ** 3, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_banks_at_unet_shapes(dev, gen, shape, dtype):
    """K1 with `[2, C]` banks at the residual UNets' extremes: C = 6 at 96^3
    (the scalar path) and C = 512 at 12^3."""
    c = shape[-1]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
    gamma = (1 + 0.2 * torch.randn((2, c), generator=gen)).to(dev, dtype)
    beta = (0.2 * torch.randn((2, c), generator=gen)).to(dev, dtype)
    styles = torch.tensor([1], dtype=torch.int32, device=dev)
    before = fused_norm.stats_launches
    scale, shift = fused_norm.channel_scale_shift(x, gamma, beta, styles)
    assert fused_norm.stats_launches == before + 1
    rs, rh = fused_norm.channel_scale_shift_plain(x, gamma, beta, styles)
    torch.cuda.synchronize()
    assert _rel(scale, rs) <= 1e-5 and _rel(shift, rh) <= 1e-5


def _k2_case(gen, dev, shape, dtype):
    b, _, c = shape
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
    add = torch.randn(shape, generator=gen).to(dev, dtype)
    sc = (1 + 0.3 * torch.randn((b, c), generator=gen)).to(dev)
    sh = (0.3 * torch.randn((b, c), generator=gen)).to(dev)
    return x, add, sc, sh


def _k3_case(gen, dev, shape, dtype):
    b, c = shape[0], shape[-1]
    x, res = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(2))
    return x, res, [torch.randn((b, c), generator=gen).to(dev) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _K2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_matches_plain_main_path(dev, gen, shape, dtype):
    x, add, sc, sh = _k2_case(gen, dev, shape, dtype)
    for a, slope in [(None, None), (None, 0.01), (add, None), (add, 0.01)]:
        before = fused_norm.apply_launches
        y = fused_norm.apply_scale_shift(x, sc, sh, a, negative_slope=slope)
        assert fused_norm.apply_launches == before + 1
        ref = fused_norm.apply_scale_shift_plain(x, sc, sh, a, negative_slope=slope)
        torch.cuda.synchronize()
        assert y.dtype == dtype and y.shape == shape
        assert _err(y, ref) <= _tol(ref, dtype), (a is not None, slope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _K3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k3_matches_plain_main_path(dev, gen, shape, dtype):
    x, res, cols = _k3_case(gen, dev, shape, dtype)
    for slope in (None, 0.01):
        y = fused_norm.apply_norm2_act(x, cols[0], cols[1], res, cols[2], cols[3],
                                       negative_slope=slope)
        ref = fused_norm.apply_norm2_act_plain(x, cols[0], cols[1], res, cols[2], cols[3],
                                               negative_slope=slope)
        torch.cuda.synchronize()
        assert _err(y, ref) <= _tol(ref, dtype), slope


def _offset(t, elements: int):
    """A contiguous copy of t that starts `elements` elements into a larger
    buffer (off a 16-byte boundary for 2)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[elements:elements + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["c100", "offset_x", "offset_res", "offset_cols"])
def test_k2_k3_scalar_variant(dev, gen, case, dtype):
    """The scalar variant: C = 100 (no 8-channel loads in bf16/f16), or an
    x, a residual or a column 2 elements into a larger buffer (16-byte
    loads misaligned), over 3 samples with their own columns."""
    shape = (3, 5 * 5 * 5, 100 if case == "c100" else 48)
    x, add, sc, sh = _k2_case(gen, dev, shape, dtype)
    if case == "offset_x":
        x = _offset(x, 2)
        assert x.data_ptr() % 16
    if case == "offset_res":
        add = _offset(add, 2)
        assert add.data_ptr() % 16
    if case == "offset_cols":
        sc = _offset(sc, 2)
        assert sc.data_ptr() % 16
    cols = [sc, sh] + [torch.randn(sc.shape, generator=gen).to(dev) for _ in range(2)]
    for slope in (None, 0.01):
        y = fused_norm.apply_scale_shift(x, sc, sh, add, negative_slope=slope)
        ref = fused_norm.apply_scale_shift_plain(x, sc, sh, add, negative_slope=slope)
        assert _err(y, ref) <= _tol(ref, dtype)
        y = fused_norm.apply_norm2_act(x, cols[0], cols[1], add, cols[2], cols[3],
                                       negative_slope=slope)
        ref = fused_norm.apply_norm2_act_plain(x, cols[0], cols[1], add, cols[2], cols[3],
                                               negative_slope=slope)
        assert _err(y, ref) <= _tol(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_k2_k3_per_sample_columns(dev, gen, dtype):
    """B = 3, 16-byte loads, each sample with its own columns: sample b's
    output is its own sample's plain result (a kernel that read another
    sample's columns would miss it)."""
    x, add, sc, sh = _k2_case(gen, dev, (3, 8 ** 3, 96), dtype)
    res_cols = [torch.randn(sc.shape, generator=gen).to(dev) for _ in range(2)]
    y2 = fused_norm.apply_scale_shift(x, sc, sh, add, negative_slope=0.01)
    y3 = fused_norm.apply_norm2_act(x, sc, sh, add, *res_cols, negative_slope=0.01)
    for b in range(3):
        ref2 = fused_norm.apply_scale_shift_plain(x[b:b + 1], sc[b:b + 1], sh[b:b + 1],
                                                  add[b:b + 1], negative_slope=0.01)
        ref3 = fused_norm.apply_norm2_act_plain(x[b:b + 1], sc[b:b + 1], sh[b:b + 1],
                                                add[b:b + 1], res_cols[0][b:b + 1],
                                                res_cols[1][b:b + 1], negative_slope=0.01)
        assert _err(y2[b:b + 1], ref2) <= _tol(ref2, dtype)
        assert _err(y3[b:b + 1], ref3) <= _tol(ref3, dtype)


def test_k2_k3_each_call_is_one_kernel(dev, gen):
    """Under torch.profiler, every K2 and K3 call is one CUDA kernel of its
    own name, the 16-byte variant where C and alignment allow and the
    scalar one (vector width 1) where not: three rounds of four calls
    launch each of these four kernels three times and no other kernel; a
    repeat is bit-identical."""
    x, add, sc, sh = _k2_case(gen, dev, (1, 48 ** 3, 48), torch.bfloat16)
    odd, odd_add, osc, osh = _k2_case(gen, dev, (1, 64, 100), torch.bfloat16)

    def calls():
        out = [fused_norm.apply_scale_shift(x, sc, sh, negative_slope=0.01),
               fused_norm.apply_scale_shift(x, sc, sh, add, negative_slope=0.01),
               fused_norm.apply_norm2_act(x, sc, sh, add, sc, sh, negative_slope=0.01),
               fused_norm.apply_scale_shift(odd, osc, osh, odd_add)]
        torch.cuda.synchronize()
        return out

    want = ["miseg_k2_apply<__nv_bfloat16, 8, 0, true>", "miseg_k2_apply<__nv_bfloat16, 8, 1, true>",
            "miseg_k3_apply2<__nv_bfloat16, 8, true>", "miseg_k2_apply<__nv_bfloat16, 1, 1, false>"]

    def ok(names):
        return len(names) == 12 and [sum(w in n for n in names) for w in want] == [3] * 4

    first = calls()   # warms up
    runs = []
    names = _device_kernels(lambda: runs.extend(calls() for _ in range(3)), ok)
    assert all(torch.equal(a, b) for run in runs for a, b in zip(first, run))
    assert ok(names), names


def test_k2_k3_reject_bad_operands(dev):
    x = torch.zeros((2, 8, 16), device=dev)
    cols = torch.zeros((2, 16), device=dev)
    with pytest.raises(ValueError):   # an add of another dtype
        fused_norm.apply_scale_shift(x, cols, cols, x.to(torch.bfloat16))
    with pytest.raises(ValueError):   # columns that are not [B, C]
        fused_norm.apply_scale_shift(x, cols[:1], cols[:1])
    with pytest.raises(ValueError):   # columns on another device
        fused_norm.apply_scale_shift(x, cols.cpu(), cols)
    with pytest.raises(ValueError):   # a non-contiguous residual
        fused_norm.apply_norm2_act(x, cols, cols, x.transpose(0, 1).contiguous().transpose(0, 1),
                                   cols, cols)


def test_identity_res_block_takes_k2_add(dev):
    """An identity-residual UnetResBlock's tail is one K2 launch (its add
    mode) and no K3."""
    from miseg_tpu_torch.nn.dynunet import UnetResBlock, _fused_convs
    from miseg_tpu_torch.models.factory import init_weights
    block = UnetResBlock(8, 8, 3, 1, "instance", device=dev)
    init_weights(block, torch.Generator().manual_seed(0))
    x = torch.randn((1, 6, 6, 6, 8), device=dev)
    fused_conv.launches = fused_norm.apply2_launches = fused_norm.apply_launches = 0
    fused_norm.stats_launches = 0
    with torch.no_grad():
        y = block(x)
        assert (fused_norm.apply_launches, fused_norm.apply2_launches) == (1, 0)
        assert (fused_conv.launches, fused_norm.stats_launches) == (2, 0)
        y2, sc2, sh2 = _fused_convs(block, x, None)
    ref = fused_norm.apply_norm2_act_plain(y2, sc2, sh2, x, torch.ones_like(sc2),
                                           torch.zeros_like(sh2), negative_slope=block.slope)
    assert _err(y, ref) <= _tol(ref, torch.float32)


def test_k3_k4_count_launches(dev):
    from miseg_tpu_torch.nn.dynunet import UnetResBlock
    from miseg_tpu_torch.models.factory import init_weights
    block = UnetResBlock(4, 8, 3, 1, "instance", device=dev)
    init_weights(block, torch.Generator().manual_seed(0))
    x = torch.randn((1, 6, 6, 6, 4), device=dev)
    fused_conv.launches = fused_norm.apply2_launches = 0
    fused_norm.stats_launches = fused_norm.apply_launches = fused_norm.fold_launches = 0
    with torch.no_grad():
        block(x)
    assert (fused_conv.launches, fused_norm.apply2_launches) == (2, 1)
    # the projected residual's norm3 is one K1 run; each K4 call one K1 fold
    assert (fused_norm.stats_launches, fused_norm.apply_launches) == (1, 0)
    assert fused_norm.fold_launches == 2


@pytest.mark.parametrize("fused", [True, False])
def test_model_forward_card_matches_cpu(dev, fused):
    """The f32 model on the card, on both conv-block paths, against the
    CPU (whose fused path runs the plain versions)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    cfg = Config(model_name="swin_unetr", out_channels=4, feature_size=[12],
                 num_heads=2, roi_x=32, roi_y=32, roi_z=32,
                 encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                 decoder_norm_name="instance")
    cpu = model_from_config(cfg, device="cpu")
    card = model_from_config(cfg, device=dev, fused_conv=fused)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 32, 1)).astype(np.float32))
    mods = torch.tensor([0, 1], dtype=torch.int32)
    fused_conv.launches = 0
    with torch.no_grad():
        want = cpu(x, mods)
        got = card(x.to(dev), mods.to(dev)).cpu()
    # fs 12 at 32^3: 9 of the 10 UnetResBlocks (encoder10 is 1^3) take the chain
    assert fused_conv.launches == (18 if fused else 0)
    assert _err(got, want) <= 1e-4 * (1 + float(want.abs().max()))


@pytest.mark.parametrize("fused", [True, False])
def test_unetr_forward_card_matches_cpu(dev, fused):
    """C-UNETR (fs 16, hidden 96, 12 heads) in f32 on the card, on both
    conv-block paths, against the CPU."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    cfg = Config(model_name="unetr", out_channels=4, feature_size=[16], hidden_size=96,
                 mlp_dim=192, num_heads=12, roi_x=32, roi_y=32, roi_z=32,
                 encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                 decoder_norm_name="instance")
    cpu = model_from_config(cfg, device="cpu")
    card = model_from_config(cfg, device=dev, fused_conv=fused)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 32, 1)).astype(np.float32))
    mods = torch.tensor([0, 1], dtype=torch.int32)
    fused_conv.launches = 0
    with torch.no_grad():
        want = cpu(x, mods)
        got = card(x.to(dev), mods.to(dev)).cpu()
    # all 8 UnetResBlocks take the chain (decoder5's 4^3 on the coarse path)
    assert fused_conv.launches == (16 if fused else 0)
    assert _err(got, want) <= 1e-4 * (1 + float(want.abs().max()))


@pytest.mark.parametrize("name", ["unet", "unet_vanilla"])
def test_unet_forward_card_matches_cpu(dev, name):
    """The residual UNets (narrow, 32^3, batch 2) in f32 on the card against
    the CPU: every norm one K1 and one K2 launch, nothing else."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    kw = (dict(feature_size=[8]) if name == "unet" else
          dict(feature_size=[8, 16, 16, 32, 32], strides=[1, 2, 2, 2, 1], num_res_units=3))
    cfg = Config(model_name=name, out_channels=6, roi_x=32, roi_y=32, roi_z=32,
                 encoder_norm_name="instance_cond", decoder_norm_name="instance", **kw)
    cpu = model_from_config(cfg, device="cpu")
    card = model_from_config(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 32, 1)).astype(np.float32))
    mods = torch.tensor([0, 1], dtype=torch.int32)
    fused_norm.stats_launches = fused_norm.apply_launches = fused_norm.fold_launches = 0
    fused_norm.apply2_launches = fused_conv.launches = wa.launches = 0
    with torch.no_grad():
        want = cpu(x, mods)
        got = card(x.to(dev), mods.to(dev)).cpu()
    norms = 13 if name == "unet" else 32
    assert (fused_norm.stats_launches, fused_norm.apply_launches) == (norms, norms)
    assert (fused_norm.fold_launches, fused_norm.apply2_launches, fused_conv.launches,
            wa.launches) == (0, 0, 0, 0)
    assert _err(got, want) <= 1e-4 * (1 + float(want.abs().max()))


# ------------------------------------------------- autograd Functions ----
# Each kernel's autograd Function on the card: its forward under grad mode
# launches the kernel, and its backward matches autograd through the
# plain version on the same inputs and cotangents.  Gradient tolerances:
# f32 as above; bf16 cases two bf16 ulps of each gradient's largest
# element (the two sides also round their bf16 forward outputs and some
# cotangents differently before the backward reads them).

def _grad_tol(ref, dtype) -> float:
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return scale * 2.0 ** -6 + 1e-6 if dtype == torch.bfloat16 else 1e-5 * (1.0 + scale)


def _grad_cases(dev, gen, dtype):
    """name -> (function, plain version, inputs, launch counter, Function
    class name) at small shapes of each kernel's paths."""
    from miseg_tpu_torch.ops import rel_bias

    def rnd(shape, scale=1.0, mean=0.0, dt=dtype):
        return (mean + scale * torch.randn(shape, generator=gen)).to(dev, dt)

    f32 = torch.float32
    styles = torch.tensor([1, 5], dtype=torch.int32, device=dev)   # 5 clamps to bank 1
    x3, add3 = rnd((2, 12 ** 3, 48), 1.5, 0.3), rnd((2, 12 ** 3, 48))
    cols = [rnd((2, 48), 0.3, m, f32) for m in (1.0, 0.0, 1.0, 0.0)]
    x5, r5 = rnd((2, 12, 12, 12, 48)), rnd((2, 12, 12, 12, 48))
    cases = {
        "k1_banks": (lambda x, g, b: fused_norm.channel_scale_shift(x, g, b, styles),
                     lambda x, g, b: fused_norm.channel_scale_shift_plain(x, g, b, styles),
                     [x3, rnd((2, 48), 0.2, 1.0), rnd((2, 48), 0.2)],
                     lambda: fused_norm.stats_launches, "_ChannelScaleShift"),
        "k1_none": (fused_norm.channel_scale_shift, fused_norm.channel_scale_shift_plain,
                    [x3], lambda: fused_norm.stats_launches, "_ChannelScaleShift"),
        "k2_add": (lambda *a: fused_norm.apply_scale_shift(*a, negative_slope=0.01),
                   lambda *a: fused_norm.apply_scale_shift_plain(*a, negative_slope=0.01),
                   [x3, cols[0], cols[1], add3], lambda: fused_norm.apply_launches,
                   "_ApplyScaleShift"),
        "k2": (fused_norm.apply_scale_shift, fused_norm.apply_scale_shift_plain,
               [x3, cols[0], cols[1]], lambda: fused_norm.apply_launches, "_ApplyScaleShift"),
        "k3": (lambda *a: fused_norm.apply_norm2_act(*a, negative_slope=0.01),
               lambda *a: fused_norm.apply_norm2_act_plain(*a, negative_slope=0.01),
               [x5, cols[0], cols[1], r5, cols[2], cols[3]],
               lambda: fused_norm.apply2_launches, "_ApplyNorm2Act"),
    }
    for name, shape, cout, prologue in (("k4_brick", (1, 16, 16, 32, 48), 48, True),
                                        ("k4_coarse", (1, 12, 12, 12, 96), 96, True),
                                        ("k4_split", (2, 6, 6, 6, 64), 64, False),
                                        ("k4_cin1", (1, 16, 16, 16, 1), 48, False)):
        b, cin = shape[0], shape[-1]
        x = rnd(shape, 1.0, 0.2)
        w = rnd((cout, cin, 3, 3, 3), (27 * cin) ** -0.5)
        bank = [rnd((2, cout), 0.2, 1.0), rnd((2, cout), 0.2)]
        sty = styles[:b]
        if prologue:
            def call(f, sty=sty):
                return lambda x_, w_, g_, b_, s_, h_: f(x_, w_, s_, h_, slope=0.01, gamma=g_,
                                                         beta=b_, styles=sty)
            args = [x, w, *bank, rnd((b, cin), 0.3, 1.0, f32), rnd((b, cin), 0.3, 0.0, f32)]
        elif name == "k4_cin1":   # the image takes no gradient
            def call(f, x=x, sty=sty):
                return lambda w_, g_, b_: f(x, w_, gamma=g_, beta=b_, styles=sty)
            args = [w, *bank]
        else:
            def call(f, sty=sty):
                return lambda x_, w_, g_, b_: f(x_, w_, gamma=g_, beta=b_, styles=sty)
            args = [x, w, *bank]
        cases[name] = (call(fused_conv.conv3_norm_columns),
                       call(fused_conv.conv3_norm_columns_plain), args,
                       lambda: fused_conv.launches, "_Conv3NormColumns")
    ids = window_region_ids((14, 14, 14), (7, 7, 7), (3, 3, 3), device=dev)
    for name, (bw, n, mask) in {"k5_mask": (16, 343, ids), "k5_clipped": (2, 216, None)}.items():
        def split(f, mask=mask):
            return lambda qkv, bias: f(qkv[..., :48], qkv[..., 48:96], qkv[..., 96:], bias,
                                       mask, num_heads=3)
        cases[name] = (split(wa.window_attention), split(wa.window_attention_plain),
                       [rnd((bw, n, 144)), rnd((3, n, n), 1.0, 0.0, f32)],
                       lambda: wa.launches, "_WindowAttention")
    index = torch.from_numpy(rel_bias.rel_pos_index((7, 7, 7)).reshape(-1)).to(dev)
    cases["rel_bias_clipped"] = (
        lambda tab: rel_bias.rel_bias_gather(tab.t(), (7, 7, 7), index)[:, :216, :216],
        lambda tab: tab.t()[:, index].reshape(3, 343, 343)[:, :216, :216],
        [rnd((13 ** 3, 3), 0.02, 0.0, f32)], None, "_RelBiasGather")   # autograd of the
    # plain index would sum a bf16 table's cotangent in bf16
    return cases


_GRAD_CASES = ["k1_banks", "k1_none", "k2_add", "k2", "k3", "k4_brick", "k4_coarse",
               "k4_split", "k4_cin1", "k5_mask", "k5_clipped", "rel_bias_clipped"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _GRAD_CASES)
def test_function_backward_matches_plain(dev, gen, case, dtype):
    fn, plain, inputs, _, _ = _grad_cases(dev, gen, dtype)[case]
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref_ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs, refs = fn(*ins), plain(*ref_ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    cts = [torch.randn(o.shape, generator=gen).to(dev, o.dtype) for o in outs]
    got = torch.autograd.grad(outs, ins, cts)
    want = torch.autograd.grad(refs, ref_ins, cts)
    # K2/K3 end in a leaky-relu: where the kernel's and the plain outputs
    # lie on two sides of 0, the backwards rightly take different branches
    apart = (outs[0] >= 0) != (refs[0] >= 0) if case[:2] in ("k2", "k3") else None
    if apart is not None:
        assert int(apart.sum()) * 10 ** 5 < apart.numel()
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        if apart is not None and g.shape == apart.shape:
            g, r = g.masked_fill(apart, 0), r.masked_fill(apart, 0)
        assert torch.isfinite(g).all(), i
        assert _err(g, r) <= _grad_tol(r, dtype), (i, _err(g, r), _grad_tol(r, dtype))


@pytest.mark.parametrize("case", [c for c in _GRAD_CASES if not c.startswith("rel_bias")])
def test_grad_mode_forward_launches_kernel(dev, gen, case):
    """Under grad mode a CUDA forward launches the kernel (its counter
    rises by one) and its output carries the Function's grad_fn."""
    fn, _, inputs, launched, function = _grad_cases(dev, gen, torch.bfloat16)[case]
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = launched()
    with torch.enable_grad():
        outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert launched() == before + 1
    assert all(type(o.grad_fn).__name__ == f"{function}Backward" for o in outs)


def test_k4_cache_rebuilds_after_optimizer_step(dev, gen):
    """K4's packed weights follow an in-place AdamW step on the card
    (foreach, the default there): the next call uses the new weights."""
    x = torch.randn((1, 8, 8, 8, 16), generator=gen).to(dev)
    w = torch.nn.Parameter(torch.randn((16, 16, 3, 3, 3), generator=gen).to(dev) * 0.1)
    opt = torch.optim.AdamW([w], lr=1e-2)
    y, _, _ = fused_conv.conv3_norm_columns(x, w)
    y.square().sum().backward()
    opt.step()
    with torch.no_grad():
        got = fused_conv.conv3_norm_columns(x, w)[0]
        want = fused_conv.conv3_norm_columns_plain(x, w)[0]
        stale = fused_conv.conv3_norm_columns_plain(x, w - w.grad)[0]
    assert _err(got, want) <= _tol(want, torch.float32)
    assert _err(stale, want) > _tol(want, torch.float32)


def test_train_step_card_matches_cpu(dev):
    """One f32 AdamW step of the fs-12 model at 32^3 on the card (both
    conv paths' kernels under autograd) against the CPU."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer
    cfg = Config(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
                 roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
                 vit_norm_name="instance_cond", decoder_norm_name="instance", no_amp=True)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, 4, (2, 32, 32, 32)), "modality": np.array([0, 1])}
    cpu, card = Trainer(cfg, device="cpu"), Trainer(cfg, device=dev)
    s_cpu = cpu.init_state()
    s_card = card.init_state(cpu.model.state_dict())
    s_cpu, l_cpu = cpu.train_step(s_cpu, batch)
    s_card, l_card = card.train_step(s_card, batch)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5
    for n, p in s_cpu.params.items():
        q = s_card.params[n]
        assert _err(q.grad.cpu(), p.grad) <= 5e-5, n
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-4, atol=2.5e-4)


def _recompute_cfg(**kw):
    from miseg_tpu_torch.config import Config
    return Config(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
                  roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
                  vit_norm_name="instance_cond", decoder_norm_name="instance", no_amp=True,
                  use_checkpoint=True, **kw)


def _launches() -> dict:
    return {"K1": fused_norm.stats_launches, "K2": fused_norm.apply_launches,
            "K3": fused_norm.apply2_launches, "K4": fused_conv.launches,
            "K5": wa.launches, "fold": fused_norm.fold_launches}


def _reset_launches() -> None:
    fused_norm.stats_launches = fused_norm.apply_launches = fused_norm.apply2_launches = 0
    fused_norm.fold_launches = fused_conv.launches = wa.launches = 0


def test_recompute_step_card_matches_cpu(dev):
    """One f32 step of the fs-12 model at 32^3 with `use_checkpoint` on the
    card against the CPU: K1-K5 run in the forward and again in the
    backward, where the recompute launches each remat'd block's kernels."""
    from miseg_tpu_torch.train.engine import Trainer
    cfg = _recompute_cfg()
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, 4, (2, 32, 32, 32)), "modality": np.array([0, 1])}
    cpu, card = Trainer(cfg, device="cpu"), Trainer(cfg, device=dev)
    s_cpu = cpu.init_state()
    s_card = card.init_state(cpu.model.state_dict())
    l_cpu, _ = cpu.value_and_grad(s_cpu, batch)
    _reset_launches()
    with torch.no_grad():
        card.apply_fn(s_card.params, torch.from_numpy(batch["image"]).to(dev),
                      torch.from_numpy(batch["modality"]).to(dev))
    forward = _launches()
    _reset_launches()
    l_card, _ = card.value_and_grad(s_card, batch)
    torch.cuda.synchronize()
    step = _launches()
    assert all(step[k] > forward[k] > 0 for k in forward), (step, forward)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5
    for n, p in s_cpu.params.items():
        assert _err(s_card.params[n].grad.cpu(), p.grad) <= 5e-5, n


def test_recompute_reuses_counters_and_packed_weights(dev, monkeypatch):
    """Under recompute: the arrival counters come from the forward's
    (device, stream) buffer and are all 0 after the step; K4's packed
    weights are packed once in the forward and reused by the recompute,
    then rebuilt after the optimizer step."""
    from miseg_tpu_torch.train.engine import Trainer
    monkeypatch.setattr(counters, "_buffers", {})
    packs = []
    pack = fused_conv.kernel_weights

    def recording(w, dtype, widths=None):
        out = pack(w, dtype, widths)
        packs.append((w.data_ptr(), out))
        return out

    monkeypatch.setattr(fused_conv, "kernel_weights", recording)
    trainer = Trainer(_recompute_cfg(), device=dev)
    state = trainer.init_state()
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, 4, (1, 32, 32, 32)), "modality": np.array([1])}
    trainer.value_and_grad(state, batch)
    torch.cuda.synchronize()
    assert list(counters._buffers) == [(torch.cuda.current_device(),
                                        torch.cuda.current_stream(dev).cuda_stream)]
    assert not bool(next(iter(counters._buffers.values())).any())
    by_weight: dict[int, list] = {}
    for ptr, out in packs:
        by_weight.setdefault(ptr, []).append(out)
    # every K4 conv sits in a remat'd block: packed in the forward, reused
    assert by_weight and all(len(v) == 2 and v[0] is v[1] for v in by_weight.values())
    first = {ptr: v[0] for ptr, v in by_weight.items()}
    state.optimizer.step()
    packs.clear()
    trainer.value_and_grad(state, batch)
    params = {p.data_ptr(): p for p in state.params.values()}
    for ptr, out in packs:
        assert out is not first[ptr]
        assert torch.equal(out, params[ptr].detach().permute(2, 3, 4, 1, 0))


# the device memory a trial may leave allocated: what a first trial makes
# once and keeps (32 MiB on an NVIDIA H100 80GB HBM3 when nothing ran
# before; not traced)
TUNE_MEMORY_MARGIN = 64 << 20


def test_tune_frees_each_trial_on_the_card(dev, tmp_path):
    """`cli.tune.main` of two bf16 trials (the swin search space, 32^3, one
    epoch each) on the card: each trial launches K1-K5, and after each the
    allocated device memory is back at its level before the study, within
    TUNE_MEMORY_MARGIN."""
    from miseg_tpu_torch import hpo
    from miseg_tpu_torch.cli import tune
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
    data = tmp_path / "data"
    make_synthetic_dataset(data, shape=(32, 32, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=6)
    cfg = Config(model_name="swin_unetr", out_channels=4, roi_x=32, roi_y=32, roi_z=32,
                 encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                 decoder_norm_name="instance", data_dirs=[str(data)] * 2,
                 json_lists=["CT.json", "MR.json"], max_epochs=1, n_trials=2, num_workers=0,
                 cache_num=4, default_root_dir=str(tmp_path / "runs"), study_name="card")
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated(dev)
    after, launched = [], []
    tell = hpo.Study.tell

    def counting_tell(self, trial, value, state="complete"):
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(dev))
        launched.append(_launches())
        _reset_launches()
        return tell(self, trial, value, state)

    _reset_launches()
    hpo.Study.tell = counting_tell
    try:
        study = tune.main(cfg, device=dev)
    finally:
        hpo.Study.tell = tell
    assert [t.state for t in study.trials] == ["complete", "complete"]
    assert all(all(n > 0 for n in counts.values()) for counts in launched), launched
    assert all(a - baseline <= TUNE_MEMORY_MARGIN for a in after), (baseline, after)



# ------------------------------------------------- exported serving bundles ----

_SERVE_CFG = dict(model_name="swin_unetr", out_channels=3, feature_size=[12], num_heads=2,
                  roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
                  vit_norm_name="instance_cond", decoder_norm_name="instance")
_SERVE_VOLUME = (40, 36, 32)   # 4 windows, padded and cropped


@pytest.fixture(scope="module")
def card_bundle(tmp_path_factory):
    """A bf16 C-Swin-UNETR bundle exported on the CPU for the card and the
    CPU, with one volume program; None without a card."""
    if not torch.cuda.is_available():
        return None
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import export_bundle
    cfg = Config(**_SERVE_CFG)
    model = model_from_config(cfg, device="cpu")
    return cfg, export_bundle(cfg, model.state_dict(), tmp_path_factory.mktemp("card") / "b",
                              platforms=("tpu", "cpu"), volume_shapes=[_SERVE_VOLUME])


def _volume(seed: int) -> torch.Tensor:
    return torch.rand((1, *_SERVE_VOLUME, 1), generator=torch.Generator().manual_seed(seed))


def _eager(served, vol, mod: int):
    """The same volume through the generic inferer over the bundle's window
    program, eagerly (no capture)."""
    inferer = served._inferer(served.window_fn, float(served.meta["infer_overlap"]),
                              "gaussian")
    return inferer(vol.to(served.device), torch.tensor([mod], dtype=torch.int32,
                                                        device=served.device))


def test_cpu_exported_program_moves_to_the_card(dev, card_bundle):
    """The `.pt2` traced on the CPU loads on the card (its constants and
    device arguments moved), launches every kernel through its op, and
    answers what the same program answers on the CPU."""
    from miseg_tpu_torch.serve import load_bundle
    _, out = card_bundle
    card, cpu = load_bundle(out, dev), load_bundle(out, "cpu")
    window = torch.rand((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(1))
    mods = torch.tensor([1], dtype=torch.int32)
    _reset_launches()
    got = card(window, mods)
    torch.cuda.synchronize()
    counts = _launches()
    assert got.is_cuda and all(counts[k] > 0 for k in counts), counts
    want = cpu(window, mods)
    assert _err(got.cpu(), want) <= 2e-2 * (1 + float(want.abs().max()))


def test_captured_volume_matches_eager_and_replays(dev, card_bundle):
    """The volume program's CUDA graph against the eager generic inferer on
    the same volume, for two replays in a row (the arrival counters start
    every replay at 0), each answer its own buffer; a replay launches no
    kernel from Python."""
    from miseg_tpu_torch.serve import load_bundle
    cfg, out = card_bundle
    served = load_bundle(out, dev)
    answers = []
    for seed, mod in ((2, 0), (3, 1), (2, 0)):
        vol = _volume(seed)
        _reset_launches()
        got = served.predict(vol, [mod])
        torch.cuda.synchronize()
        prog = served.volume_program(_SERVE_VOLUME, 1, cfg.infer_overlap, "gaussian")
        assert prog is not None and prog.graph is not None
        if answers:   # replays: nothing launched from Python
            assert all(v == 0 for v in _launches().values()), _launches()
        want = _eager(served, vol, mod)
        assert got.shape == want.shape == (1, *_SERVE_VOLUME, cfg.out_channels)
        assert _err(got, want) <= 1e-3 * (1 + float(want.abs().max()))
        answers.append(got)
    assert answers[0].data_ptr() != answers[2].data_ptr()
    assert torch.equal(answers[0], answers[2])


def test_window_graph_matches_program_and_replays(dev, card_bundle):
    """The served window is one CUDA graph of a window batch: its answers
    against the window program run as it is, for replays in a row (each
    answer its own buffer, nothing launched from Python), and a volume no
    program covers, through the window graph in the generic inferer,
    against the eager generic inferer."""
    from miseg_tpu_torch.serve import load_bundle
    cfg, out = card_bundle
    served = load_bundle(out, dev)
    gen = torch.Generator().manual_seed(4)
    windows = [torch.rand((1, 32, 32, 32, 1), generator=gen).to(dev) for _ in range(2)]
    answers = []
    for window, mod in ((windows[0], 0), (windows[1], 1), (windows[0], 0)):
        mods = torch.tensor([mod], dtype=torch.int32, device=dev)
        _reset_launches()
        got = served(window, mods)
        torch.cuda.synchronize()
        if answers:
            assert all(v == 0 for v in _launches().values()), _launches()
        with torch.inference_mode():
            want = served.window_fn(window, mods)
        assert _err(got, want) <= 1e-3 * (1 + float(want.abs().max()))
        answers.append(got)
    assert served.window_graph.graph is not None and served.window_graph.calls == 3
    assert answers[0].data_ptr() != answers[2].data_ptr()
    assert torch.equal(answers[0], answers[2])
    vol = torch.rand((1, 36, 40, 32, 1), generator=gen)
    got = served.predict(vol, [1])
    want = _eager(served, vol, 1)
    assert _err(got, want) <= 1e-3 * (1 + float(want.abs().max()))


def test_threaded_predict_on_one_program(dev, card_bundle):
    """Four threads replay one volume program at once on different volumes;
    each answer is its volume's serial answer."""
    import threading

    from miseg_tpu_torch.serve import load_bundle
    _, out = card_bundle
    served = load_bundle(out, dev)
    vols = [_volume(10 + i) for i in range(4)]
    serial = [served.predict(v, [i % 2]).clone() for i, v in enumerate(vols)]
    results, barrier = {}, threading.Barrier(4)

    def client(i):
        barrier.wait(timeout=60)
        with torch.inference_mode():
            results[i] = served.predict(vols[i], [i % 2])
        torch.cuda.synchronize()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert sorted(results) == [0, 1, 2, 3]
    for i in range(4):
        assert torch.equal(results[i], serial[i])


# K4's D-halo mode (spatial partitioning): a slab with a halo plane a side,
# [B, Dl + 2, Y, X, Cin], one shape a path (brick, coarse, FMA, Cin = 1)
_HALO = {"brick": ((1, 8 + 2, 16, 16, 48), 48), "coarse": ((1, 4 + 2, 8, 8, 96), 96),
         "fma": ((1, 6 + 2, 12, 12, 64), 64), "cin1": ((1, 8 + 2, 16, 16, 1), 48)}


@pytest.mark.parametrize("pads", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("case", sorted(_HALO))
def test_k4_halo_mode_matches_plain(dev, gen, case, pads):
    """bf16: y within one ulp of the plain version's, the fold's moments
    mode within 1e-5 relative of the plain moments of the kernel's own y,
    counted in `halo_launches` and `fold_moments_launches` alone."""
    shape, cout = _HALO[case]
    b, cin = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen) / (27 * cin) ** 0.5).to(
        dev, torch.bfloat16)
    kw = {} if cin == 1 else dict(
        scale=(1 + 0.3 * torch.randn((b, cin), generator=gen)).to(dev),
        shift=(0.3 * torch.randn((b, cin), generator=gen)).to(dev), slope=0.01)
    before = (fused_conv.launches, fused_conv.halo_launches, fused_norm.fold_launches,
              fused_norm.fold_moments_launches)
    with torch.no_grad():
        y, mean, m2 = fused_conv.conv3_halo_moments(x, w, pad_lo=pads[0], pad_hi=pads[1], **kw)
    torch.cuda.synchronize()
    assert (fused_conv.launches, fused_conv.halo_launches, fused_norm.fold_launches,
            fused_norm.fold_moments_launches) == (before[0], before[1] + 1, before[2],
                                                  before[3] + 1)
    ref = fused_conv.conv3_halo_moments_plain(x, w, pad_lo=pads[0], pad_hi=pads[1], **kw)[0]
    assert y.shape == ref.shape and _err(y, ref) <= _tol(ref, torch.bfloat16)
    rm, rq = fused_norm.channel_moments_plain(y.reshape(b, -1, cout))
    assert _err(mean, rm) <= 1e-5 * (1 + float(rm.abs().max()))
    assert _err(m2, rq) <= 1e-5 * (1 + float(rq.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5000, 48), (1, 27, 768), (1, 4096, 6)])
def test_k1_moments_mode_matches_plain(dev, gen, shape, dtype):
    """K1's moments mode: each sample's (mean, M2) within 1e-5 relative of
    the plain two-pass version, one launch counted in `moments_launches`."""
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
    before = (fused_norm.stats_launches, fused_norm.moments_launches)
    with torch.no_grad():
        mean, m2 = fused_norm.channel_moments(x)
    assert (fused_norm.stats_launches, fused_norm.moments_launches) == (before[0],
                                                                      before[1] + 1)
    rm, rq = fused_norm.channel_moments_plain(x)
    assert _err(mean, rm) <= 1e-5 * (1 + float(rm.abs().max()))
    assert _err(m2, rq) <= 1e-5 * (1 + float(rq.abs().max()))
