#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`miseg_tpu_torch`) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one result line each; any failed check exits non-zero:
  1. device  — torch/CUDA versions, the card's name and power limit, the
               kernels' build (nvcc for K1-K5, one process per source,
               started together), and a check that the bf16 K5 kernel and
               K4's brick, coarse and Cin = 1 kernels hold tensor-core
               instructions in their SASS;
  2. kernels — K1 (and its fold of K4's partials), K2, K3, K4 and K5
               against their plain PyTorch versions on the card, in bf16
               and f32, at the shapes of the 96^3 flagship (K2, with and
               without its add, and K3 at every shape the served window
               gives them), with CUDA-event times of kernel, plain version
               and a library yardstick the port never calls, beside each
               kernel's bound; for K1-K4 also the device times
               (torch.profiler; "not measured" where no session of three
               recorded a kernel a call) of the kernel (and of
               `torch.var_mean` / `F.conv3d`) at each shape; and the host
               time of one K1, K2 and K3 wrapper call at a small shape;
  3. model   — one full-width (feature_size 48, heads 3) window in f32,
               card against CPU, through the fused conv chain (the
               default) and through the unfused path (`fused_conv=False`);
  4. serve   — a full-width C-Swin-UNETR bundle (seeded random weights,
               bf16, 96^3 ROI, gaussian blend, overlap 0.5) answers
               volume requests through `load_bundle(...).predict`; the
               kernels' launch counters must rise by the per-window counts.
               Then one window through the fused and the unfused model
               (same weights), and a profile of one window, which fails
               unless the window ran 20 K4 kernels (12 coarse, one Cin = 1,
               none on the FMA path or its split-K reduce), 51 K1 kernels
               (31 statistics, 20 folds), 29 K2 and 6 K3 kernels, all of
               them the CUDA ones;
  5. train   — training through `train.engine.Trainer`: (a) each kernel's
               autograd Function (K1 with banks and K2 with its add at
               [1,48^3,48], K3 at [1,96^3,48], K4 with a prologue at 96^3,
               12^3 and 6^3 and the Cin = 1 call, K5 at stage 1 with and
               without the mask) in bf16, its forward under grad mode
               launching the kernel and its backward against autograd
               through the plain version; (b) one f32 AdamW step of the
               fs-48 model at 64^3 on the card against the CPU; (c) the
               flagship's step at 96^3, bf16 compute with f32 masters, 2
               warm-up and 10 timed steps on a fixed seeded batch (finite
               losses, a falling loss, finite non-zero gradients for all
               203 parameters, the window's launch counts in one step's
               forward, ms a step, device busy and idle share of one
               profiled step, peak memory).
Then one JSON line of kernels (with each kernel's launches a train step
and the JAX VJP its backward follows), the card line, and the ok line last.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# one 96^3 window of the flagship.  The 10 UnetResBlocks run the fused
# conv chain: two K4 launches (their folds count nothing), then the tail:
# the 6 with a projected residual (encoder1, decoder5..decoder1) one K1
# run for norm3 and one K3 launch, the 4 with an identity residual
# (encoder2-4, encoder10) one K2 launch in its add mode.  The other norms
# (16 swin-block, 4 patch merging, 5 parameter-free proj_out) are one K1
# run and one K2 launch each; one K5 launch per swin block (4 stages x
# 2).  Each K4 call folds its statistics with one K1 fold launch.
PER_WINDOW = {"K1": 31, "K2": 29, "K3": 6, "K4": 20, "K5": 8, "K1 fold": 20}
# K2 at the unfused path's [1, 96^3, 48] (the served path never runs it
# there: the fused chain covers every 96^3 norm) and at every shape the
# served window gives it: the identity tails (add mode) are 48^3 x 48,
# 24^3 x 96, 12^3 x 192 and 3^3 x 768; K3 at every projected-residual tail
# of a window, and at 3^3 x 768, off the served path (encoder10's tail is
# K2's add mode there), as the smallest tensor K3 is held at
K2_SHAPES = [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 24 ** 3, 384), (1, 24 ** 3, 96),
             (1, 12 ** 3, 768), (1, 12 ** 3, 192), (1, 6 ** 3, 1536), (1, 6 ** 3, 384),
             (1, 27, 3072), (1, 27, 768)]
K3_SHAPES = [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 24 ** 3, 96), (1, 12 ** 3, 192),
             (1, 6 ** 3, 384), (1, 27, 768)]
K3_OFF_PATH = {(1, 27, 768)}
FLAGSHIP = dict(model_name="swin_unetr", out_channels=6, feature_size=[48],
                num_heads=3, depth_swin_block=[2], roi_x=96, roi_y=96,
                roi_z=96, encoder_norm_name="instance_cond",
                vit_norm_name="instance_cond", decoder_norm_name="instance",
                infer_overlap=0.5, sw_batch_size=1)
# (memory B/s, dense bf16 FLOP/s) from NVIDIA's data sheets
PEAKS = {"PCIe": (2.0e12, 756e12), "NVL": (3.9e12, 835e12),
         "SXM": (3.35e12, 989e12)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_peaks(name: str) -> tuple[float, float, str]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return (*PEAKS[key], f"H100 {key}")
    return (*PEAKS["SXM"], "H100 SXM")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(run, ok, attempts: int = 3) -> list:
    """The device events torch.profiler records while `run()` runs, from the
    first of `attempts` sessions whose events satisfy `ok(events)`, else
    from the last.  The profiler misses kernels launched right after a
    session starts (and now and then a whole session's), so each session
    first runs ATen's `spin_kernel` (`torch.cuda._sleep`), left out of the
    events; a kernel that launches wrongly fails every session.  Device-side
    user annotations (the optimizer's `Optimizer.step` range) are left out
    too: they span kernels that are counted on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
                  and not getattr(e, "is_user_annotation", False)]
        if ok(events):
            break
    return events


def device_ms(fn, match: str | None = None, reps: int = 10) -> float | None:
    """Device time of one call of `fn` in ms: the summed duration of its
    kernels (only those whose names hold `match`, if given) under
    torch.profiler, averaged over `reps` calls.  None where no session
    recorded at least `reps` such kernels: a sum over fewer calls is no
    time of one."""
    fn()
    torch.cuda.synchronize()

    def matching(events):
        return [e for e in events if match is None or match in e.name]

    def calls():
        for _ in range(reps):
            fn()

    events = matching(profiled(calls, lambda ev: len(matching(ev)) >= reps))
    if len(events) < reps:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tolerance(ref: torch.Tensor, dtype) -> float:
    """f32: 1e-5 relative to the output's scale (summation order, FMA);
    bf16: one bf16 ulp of the largest output (one rounding of f32 values
    that may differ in the last bit)."""
    scale = float(ref.abs().max())
    return scale * 2.0 ** -7 + 1e-6 if dtype == torch.bfloat16 else 1e-5 * (1.0 + scale)


def phase_device():
    from miseg_tpu_torch.ops.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  nvcc {name}: " + " | ".join(regs))
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"card '{card}' count {torch.cuda.device_count()} "
          f"nvcc build {build_s:.2f} s")
    check_tensor_cores(build)
    return card


def check_tensor_cores(build) -> None:
    """Every instance of the bf16 K5 kernel and of K4's brick, coarse and
    Cin = 1 kernels holds tensor-core instructions (HMMA/HGMMA) in the
    built SASS."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    for source, kernel in (("window_attention", "miseg_k5_attn_mma"),
                           ("fused_conv", "miseg_k4_conv_brick"),
                           ("fused_conv", "miseg_k4_conv_coarse"),
                           ("fused_conv", "miseg_k4_conv_cin1")):
        sass = subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            if "Function : " in line:
                name = line.split("Function : ")[1].strip()
                current = name if kernel in name else None
                if current:
                    counts[current] = 0
            elif current and ("HMMA" in line or "HGMMA" in line):
                counts[current] += 1
        check(bool(counts) and min(counts.values()) > 0,
              f"{kernel}: tensor-core instructions per instance {sorted(counts.values())}")
        print(f"  sass {kernel}: {len(counts)} instances, HMMA/HGMMA per instance "
              f"{min(counts.values())}..{max(counts.values())}")


def phase_kernels(dev, mem_bw: float, bf16_flops: float) -> dict:
    import torch.nn.functional as F

    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    from miseg_tpu_torch.ops.window import window_region_ids

    # every library loaded before the first profiler session: one first
    # loaded after a session showed no device events in later sessions
    fn._k1(), fn._k23(), fc._entry(), wa._lib()
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    rows, k2_ms = phase_norm_apply(dev, mem_bw, gen)
    # ---- K1 at main-path norm shapes -------------------------------------
    for shape in [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 27, 3072)]:
        b, s, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
            gamma = (1 + 0.2 * torch.randn((2, c), generator=gen)).to(dev, dtype)
            beta = (0.2 * torch.randn((2, c), generator=gen)).to(dev, dtype)
            styles = torch.tensor([1], dtype=torch.int32, device=dev)
            scale, shift = fn.channel_scale_shift(x, gamma, beta, styles)
            rs, rh = fn.channel_scale_shift_plain(x, gamma, beta, styles)
            e1 = max(max_err(scale, rs) / (1 + float(rs.abs().max())),
                     max_err(shift, rh) / (1 + float(rh.abs().max())))
            check(e1 <= 1e-5, f"K1 {shape} {dtype}: relative error {e1:.2e} > 1e-5")
            line = f"  K1 {list(shape)} {str(dtype)[6:]}: rel err {e1:.2e} (tol 1e-05)"
            if dtype == torch.bfloat16:
                nbytes = x.numel() * x.element_size()
                k1 = time_ms(lambda: fn.channel_scale_shift(x, gamma, beta, styles))
                k1_plain = time_ms(lambda: fn.channel_scale_shift_plain(x, gamma, beta, styles))
                k1_lib = time_ms(lambda: torch.var_mean(x, dim=1, correction=0))
                dev_k1 = device_ms(lambda: fn.channel_scale_shift(x, gamma, beta, styles),
                                   "miseg_k1_")
                dev_lib = device_ms(lambda: torch.var_mean(x, dim=1, correction=0))
                side = round(s ** (1 / 3))   # every shape here is a cube
                xcf = x.reshape(b, side, side, side, c).permute(0, 4, 1, 2, 3)
                inorm = time_ms(lambda: F.instance_norm(xcf))
                b1 = nbytes / mem_bw * 1e3
                line += (f"\n    times ms: K1 {k1:.4f} (bound {b1:.4f}, plain {k1_plain:.4f}, "
                         f"torch.var_mean {k1_lib:.4f}; device: K1 {fmt_ms(dev_k1)}, "
                         f"torch.var_mean {fmt_ms(dev_lib)}); K1+K2 {k1 + k2_ms[shape]:.4f} vs "
                         f"F.instance_norm {inorm:.4f}")
                if shape == (1, 96 ** 3, 48):
                    rows["K1"] = dict(ms=k1, plain_ms=k1_plain, bound_ms=b1,
                                      bound_by="bytes", library_ms=k1_lib,
                                      max_abs_err=max(max_err(scale, rs), max_err(shift, rh)))
            print(line)
    # ---- K1's fold of K4's brick partials (96^3: 3456 a sample, 48^3: 432)
    for side, cout in ((96, 48), (48, 48)):
        s_vox, rows_t = side ** 3, 256
        n_tiles = s_vox // rows_t
        part = torch.stack([torch.randn((n_tiles, cout), generator=gen) + 0.5,
                            torch.rand((n_tiles, cout), generator=gen) * rows_t]).to(dev)
        gamma = (1 + 0.2 * torch.randn((2, cout), generator=gen)).to(dev, torch.bfloat16)
        beta = (0.2 * torch.randn((2, cout), generator=gen)).to(dev, torch.bfloat16)
        styles = torch.tensor([1], dtype=torch.int32, device=dev)
        args = (part, s_vox, rows_t, n_tiles, gamma, beta, styles)
        got, want = fn.fold_partials(*args), fn.fold_partials_plain(*args)
        ef = max(max_err(a, b) / (1 + float(b.abs().max())) for a, b in zip(got, want))
        check(ef <= 1e-5, f"K1 fold {n_tiles} partials: relative error {ef:.2e} > 1e-5")
        fold = time_ms(lambda: fn.fold_partials(*args))
        fold_plain = time_ms(lambda: fn.fold_partials_plain(*args))
        dev_fold = device_ms(lambda: fn.fold_partials(*args), "miseg_k1_")
        bound = (part.numel() * 4 + 2 * cout * 4 + 2 * gamma.numel() * 2) / mem_bw * 1e3
        print(f"  K1 fold {n_tiles} partials x {cout}: rel err {ef:.2e} (tol 1e-05)"
              f"\n    times ms: fold {fold:.4f} (device {fmt_ms(dev_fold)}; bound {bound:.5f} by "
              f"bytes), plain {fold_plain:.4f}")
        if side == 96:
            rows["K1 fold"] = dict(ms=fold, plain_ms=fold_plain, bound_ms=bound,
                                   bound_by="bytes", library_ms=None,
                                   max_abs_err=max(max_err(a, b) for a, b in zip(got, want)))
    # ---- K5 at the four swin stages of a 96^3 window -------------------
    stages = [  # (window batch, N, channels, heads, padded dims for ids)
        (343, 343, 48, 3, (49, 49, 49)),
        (64, 343, 96, 6, (28, 28, 28)),
        (8, 343, 192, 12, (14, 14, 14)),
        (1, 216, 384, 24, None),       # clipped 6^3 window, unshifted
    ]
    for stage, (bw, n, c, heads, padded) in enumerate(stages, start=1):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, dtype)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            bias = torch.randn((heads, n, n), generator=gen).to(dev)
            if padded is not None:
                real_ids = window_region_ids(padded, (7, 7, 7), (3, 3, 3), device=dev)
            else:  # stage 4 is never shifted; random regions still test the mask
                real_ids = torch.randint(0, 3, (bw, n), generator=gen,
                                         dtype=torch.int32).to(dev)
            line = f"  K5 stage {stage} [{bw},{n},{c}] h{heads} {str(dtype)[6:]}:"
            errs = {}
            for ids in (None, real_ids):
                out = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
                ref = wa.window_attention_plain(q, k, v, bias, ids, num_heads=heads)
                e, tol = max_err(out, ref), tolerance(ref, dtype)
                check(e <= tol, f"K5 stage {stage} {dtype} ids={ids is not None}: "
                                f"{e:.3e} > {tol:.3e}")
                errs[ids is not None] = e
                line += f" {'ids' if ids is not None else 'no ids'} err {e:.3e} (tol {tol:.3e});"
            if dtype == torch.bfloat16:
                ids = real_ids if padded is not None else None
                hd = c // heads
                k5 = time_ms(lambda: wa.window_attention(q, k, v, bias, ids, num_heads=heads))
                plain = time_ms(lambda: wa.window_attention_plain(
                    q, k, v, bias, ids, num_heads=heads), reps=5)
                mask = bias[None].to(dtype)
                if ids is not None:
                    neq = (ids[:, None, :] != ids[:, :, None]).to(dtype) * -100.0
                    mask = (bias[None] + neq[:, None]).to(dtype)
                qh, kh, vh = (t.view(bw, n, heads, hd).transpose(1, 2) for t in (q, k, v))
                sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask))
                nbytes = (4 * bw * n * c * 2 + bias.numel() * 4
                          + (ids.numel() * 4 if ids is not None else 0))
                flops = 4 * bw * heads * n * n * hd
                bound = max(nbytes / mem_bw, flops / bf16_flops) * 1e3
                by = "bytes" if nbytes / mem_bw >= flops / bf16_flops else "operations"
                line += (f"\n    times ms: K5 {k5:.4f} (bound {bound:.4f} by {by}: "
                         f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {plain:.4f}, "
                         f"F.scaled_dot_product_attention {sdpa:.4f}")
                if stage == 1:
                    rows["K5"] = dict(ms=k5, plain_ms=plain, bound_ms=bound, bound_by=by,
                                      library_ms=sdpa, max_abs_err=errs[ids is not None])
            print(line)
    # ---- K4 at the conv shapes of the 96^3 window's UnetResBlocks ------
    # (every (shape, Cout) of the 20 calls; the 96^3 and 48^3 levels take
    # the brick path, 24^3 and below the coarse path)
    convs = [  # (label, x shape, Cout, prologue: norm1's columns + leaky)
        ("encoder1 conv1", (1, 96, 96, 96, 1), 48, False),
        ("encoder1/decoder1 conv2", (1, 96, 96, 96, 48), 48, True),
        ("decoder1 conv1", (1, 96, 96, 96, 96), 48, False),
        ("encoder2/decoder2 conv2", (1, 48, 48, 48, 48), 48, True),
        ("decoder2 conv1", (1, 48, 48, 48, 96), 48, False),
        ("encoder3/decoder3 conv2", (1, 24, 24, 24, 96), 96, True),
        ("decoder3 conv1", (1, 24, 24, 24, 192), 96, False),
        ("encoder4/decoder4 conv2", (1, 12, 12, 12, 192), 192, True),
        ("decoder4 conv1", (1, 12, 12, 12, 384), 192, False),
        ("decoder5 conv1", (1, 6, 6, 6, 768), 384, False),
        ("decoder5 conv2", (1, 6, 6, 6, 384), 384, True),
        ("encoder10 conv2", (1, 3, 3, 3, 768), 768, True),
    ]
    for label, shape, cout, prologue in convs:
        b, cin = shape[0], shape[-1]
        s_vox = shape[1] * shape[2] * shape[3]
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
            w = (torch.randn((cout, cin, 3, 3, 3), generator=gen)
                 / (27 * cin) ** 0.5).to(dev, dtype)
            kw = dict(gamma=(1 + 0.2 * torch.randn((2, cout), generator=gen)).to(dev, dtype),
                      beta=(0.2 * torch.randn((2, cout), generator=gen)).to(dev, dtype),
                      styles=torch.tensor([1], dtype=torch.int32, device=dev))
            if prologue:
                kw.update(scale=(1 + 0.3 * torch.randn((b, cin), generator=gen)).to(dev),
                          shift=(0.3 * torch.randn((b, cin), generator=gen)).to(dev),
                          slope=0.01)
            y, sc, sh = fc.conv3_norm_columns(x, w, **kw)
            ref = fc.conv3_norm_columns_plain(x, w, **kw)[0]
            e, tol = max_err(y, ref), tolerance(ref, dtype)
            check(e <= tol, f"K4 {label} {dtype}: {e:.3e} > {tol:.3e}")
            # the epilogue's columns against the plain fold of the kernel's
            # own y: isolates the statistics from the conv's rounding
            rs, rh = fn.channel_scale_shift_plain(y.reshape(b, -1, cout), kw["gamma"],
                                                  kw["beta"], kw["styles"])
            ec = max(max_err(sc, rs) / (1 + float(rs.abs().max())),
                     max_err(sh, rh) / (1 + float(rh.abs().max())))
            check(ec <= 1e-5, f"K4 {label} {dtype}: columns rel err {ec:.2e} > 1e-5")
            line = (f"  K4 {label} {list(shape)}->{cout} {str(dtype)[6:]}: err {e:.3e} "
                    f"(tol {tol:.3e}), columns rel err {ec:.2e} (tol 1e-05)")
            if dtype == torch.bfloat16:
                k4 = time_ms(lambda: fc.conv3_norm_columns(x, w, **kw))
                plain = time_ms(lambda: fc.conv3_norm_columns_plain(x, w, **kw), reps=5)
                xcf = x.permute(0, 4, 1, 2, 3)   # channels_last_3d, as the unfused path
                lib = time_ms(lambda: F.conv3d(xcf, w, padding=1))
                # on the device: at the coarse levels CUDA events time the host
                dev_k4 = device_ms(lambda: fc.conv3_norm_columns(x, w, **kw), "miseg_k4_")
                dev_call = device_ms(lambda: fc.conv3_norm_columns(x, w, **kw))
                dev_lib = device_ms(lambda: F.conv3d(xcf, w, padding=1))
                nbytes = ((x.numel() + w.numel() + s_vox * b * cout) * x.element_size()
                          + 2 * b * cin * 4 * prologue + 2 * b * cout * 4
                          + 2 * kw["gamma"].numel() * x.element_size())
                flops = 2 * b * s_vox * 27 * cin * cout
                bound = max(nbytes / mem_bw, flops / bf16_flops) * 1e3
                by = "bytes" if nbytes / mem_bw >= flops / bf16_flops else "operations"
                line += (f"\n    times ms: K4 {k4:.4f} (bound {bound:.4f} by {by}: "
                         f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
                         f"{flops / k4 / 1e9:.1f} TFLOP/s), plain {plain:.4f}, "
                         f"F.conv3d {lib:.4f}"
                         f"\n    device ms: K4 kernel {fmt_ms(dev_k4)} (with its fold "
                         f"{fmt_ms(dev_call)}), F.conv3d {fmt_ms(dev_lib)}")
                if label == "encoder1/decoder1 conv2":
                    rows["K4"] = dict(ms=k4, plain_ms=plain, bound_ms=bound, bound_by=by,
                                      library_ms=lib, max_abs_err=e)
            print(line)
    torch.cuda.synchronize()
    host_cost(dev)
    print(f"kernels: K1, K1 fold, K2, K3, K4, K5 match their plain versions at main-path "
          f"shapes in bf16 and f32 ({time.perf_counter() - t0:.1f} s)")
    return rows


def phase_norm_apply(dev, mem_bw: float, gen) -> tuple[dict, dict]:
    """K2 (with and without its add) at `K2_SHAPES` and K3 at `K3_SHAPES`
    against their plain versions in bf16 and f32, with CUDA-event and
    device times and byte bounds in bf16.  Returns the `kernels` rows of K2
    (at [1, 48^3, 48], its largest served shape) and K3 (at [1, 96^3, 48]),
    and K2's event ms by shape."""
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    rows, k2_ms = {}, {}
    slope = 0.01
    for shape in K2_SHAPES:
        b, s, c = shape
        line, timed = f"  K2 {list(shape)}:", ""
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
            add = torch.randn(shape, generator=gen).to(dev, dtype)
            sc = (1 + 0.3 * torch.randn((b, c), generator=gen)).to(dev)
            sh = (0.3 * torch.randn((b, c), generator=gen)).to(dev)
            errs = []
            for a in (None, add):
                y = fn.apply_scale_shift(x, sc, sh, a, negative_slope=slope)
                ref = fn.apply_scale_shift_plain(x, sc, sh, a, negative_slope=slope)
                e, tol = max_err(y, ref), tolerance(ref, dtype)
                check(e <= tol, f"K2 {shape} {dtype} add={a is not None}: {e:.3e} > {tol:.3e}")
                errs.append(e)
                line += (f" {str(dtype)[6:]}{'+add' if a is not None else ''} err {e:.3e} "
                         f"(tol {tol:.3e});")
            if dtype != torch.bfloat16:
                continue
            nbytes, cols = x.numel() * x.element_size(), 2 * b * c * 4
            times = {}
            for label, a in (("K2", None), ("K2+add", add)):
                call = lambda a=a: fn.apply_scale_shift(x, sc, sh, a, negative_slope=slope)  # noqa: E731
                times[label] = (time_ms(call), device_ms(call, "miseg_k2_"),
                                ((3 if a is not None else 2) * nbytes + cols) / mem_bw * 1e3)
            plain = time_ms(lambda: fn.apply_scale_shift_plain(x, sc, sh, None,
                                                                negative_slope=slope))
            timed = "\n    bf16 ms: " + "; ".join(
                f"{k} {ev:.4f} (device {fmt_ms(dv)}, bound {bd:.5f} by bytes)"
                for k, (ev, dv, bd) in times.items()) + f"; plain {plain:.4f}"
            k2_ms[shape] = times["K2"][0]
            if shape == (1, 48 ** 3, 48):
                rows["K2"] = dict(ms=times["K2"][0], plain_ms=plain, bound_ms=times["K2"][2],
                                  bound_by="bytes", library_ms=None, max_abs_err=errs[0])
        print(line + timed)
    for shape in K3_SHAPES:
        b, s, c = shape
        note = " (off the served path)" if shape in K3_OFF_PATH else ""
        line, timed = f"  K3 {list(shape)}{note}:", ""
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            res = torch.randn(shape, generator=gen).to(dev, dtype)
            cols = [torch.randn((b, c), generator=gen).to(dev) for _ in range(4)]
            call = lambda: fn.apply_norm2_act(x, *cols[:2], res, *cols[2:],  # noqa: E731
                                              negative_slope=slope)
            y = call()
            ref = fn.apply_norm2_act_plain(x, *cols[:2], res, *cols[2:], negative_slope=slope)
            e, tol = max_err(y, ref), tolerance(ref, dtype)
            check(e <= tol, f"K3 {shape} {dtype}: {e:.3e} > {tol:.3e}")
            line += f" {str(dtype)[6:]} err {e:.3e} (tol {tol:.3e});"
            if dtype != torch.bfloat16:
                continue
            k3, dev_k3 = time_ms(call), device_ms(call, "miseg_k3_")
            plain = time_ms(lambda: fn.apply_norm2_act_plain(x, *cols[:2], res, *cols[2:],
                                                             negative_slope=slope))
            bound = (3 * x.numel() * x.element_size() + 4 * b * c * 4) / mem_bw * 1e3
            timed = (f"\n    bf16 ms: K3 {k3:.4f} (device {fmt_ms(dev_k3)}, bound {bound:.5f} "
                     f"by bytes); plain {plain:.4f}")
            if shape == (1, 96 ** 3, 48):
                rows["K3"] = dict(ms=k3, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                                  library_ms=None, max_abs_err=e)
        print(line + timed)
    return rows, k2_ms


def host_cost(dev, calls: int = 200, rounds: int = 5) -> None:
    """Host time of one wrapper call of K1, K2 (with and without its add)
    and K3 at [1, 27, 768] bf16: `calls` back-to-back calls after a
    synchronize, on the host clock up to the last call's return (the
    device work is a few us a call, so the host sets the pace), median of
    `rounds` rounds, the kernels taken in turns, in reverse order every
    other round; beside it the time to the end of the synchronize after
    them.  Twice: under inference mode, as served (the wrappers call the
    launchers directly), and under grad mode with x requiring a gradient
    (the wrappers run inside their autograd Functions, as in training).
    The host's speed swings between runs: compare kernels within a run,
    K1 being the same code in the trees compared so far."""
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    gen = torch.Generator().manual_seed(5)
    base = [torch.randn((1, 27, 768), generator=gen).to(dev, torch.bfloat16) for _ in range(2)]
    for grad in (False, True):
        x, r = (t.detach().requires_grad_(grad) for t in base)
        with torch.no_grad():
            sc, sh = fn.channel_scale_shift(x)
        calls_of = {
            "K1": lambda: fn.channel_scale_shift(x),
            "K2": lambda: fn.apply_scale_shift(x, sc, sh, negative_slope=0.01),
            "K2+add": lambda: fn.apply_scale_shift(x, sc, sh, r, negative_slope=0.01),
            "K3": lambda: fn.apply_norm2_act(x, sc, sh, r, sc, sh, negative_slope=0.01),
        }
        took: dict[str, list[tuple[float, float]]] = {k: [] for k in calls_of}
        with torch.enable_grad() if grad else torch.inference_mode():
            for rnd in range(rounds):
                for name, call in (reversed(calls_of.items()) if rnd % 2 else calls_of.items()):
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        call()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    took[name].append(((t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6))
        mode = "grad mode, in the autograd Functions" if grad else "inference mode, as served"
        print(f"host ({mode}): us a wrapper call at [1,27,768] bf16 ({calls} calls after a "
              f"synchronize, median of {rounds} rounds; to the last return / to the end of the "
              f"synchronize): "
              + ", ".join(f"{k} {statistics.median(a for a, _ in v):.2f} / "
                          f"{statistics.median(b for _, b in v):.2f}" for k, v in took.items()))


def phase_model(dev):
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.ops.kernels import fused_conv as fc

    size = 64
    cfg = Config(**{**FLAGSHIP, "roi_x": size, "roi_y": size, "roi_z": size})
    cpu = model_from_config(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, size, size, size, 1), generator=gen)
    mods = torch.tensor([1], dtype=torch.int32)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x, mods)
        cpu_s = time.perf_counter() - t0
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    errs = {}
    for fused in (True, False):   # the fused conv chain is the default
        card = model_from_config(cfg, device=dev, fused_conv=fused)
        card.load_state_dict(cpu.state_dict())
        fc.launches = 0
        with torch.inference_mode():
            got = card(x.to(dev), mods.to(dev)).cpu()
        name = "fused" if fused else "unfused"
        check(fc.launches == (20 if fused else 0),
              f"model {name}: {fc.launches} K4 launches")
        check(torch.isfinite(got).all().item(), f"model {name}: non-finite logits")
        errs[name] = max_err(got, want)
        check(errs[name] <= tol, f"model {name}: card vs CPU {errs[name]:.3e} > {tol:.3e}")
        del card
    print(f"model: fs48 heads 3, one {size}^3 window, f32 (TF32 off): card vs CPU "
          f"max |diff| fused chain {errs['fused']:.3e}, unfused {errs['unfused']:.3e} "
          f"(tol {tol:.3e}, |logits| <= {float(want.abs().max()):.3f}); "
          f"CPU forward {cpu_s:.1f} s")


def phase_serve(dev) -> dict:
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    cfg = Config(**FLAGSHIP)
    gen = torch.Generator().manual_seed(2)
    with tempfile.TemporaryDirectory() as tmp:
        model = model_from_config(cfg, device=dev)
        save_bundle(cfg, model.state_dict(), tmp)
        del model
        served = load_bundle(tmp)
    check(served.compute_dtype == torch.bfloat16, "serve: bundle is not bf16")
    vol_a = torch.rand((1, 224, 224, 224, 1), generator=gen)
    vol_b = torch.rand((1, 160, 192, 128, 1), generator=gen)
    requests = [("224^3 modality 0", vol_a, 0), ("224^3 modality 1", vol_a, 1),
                ("160x192x128 modality 0", vol_b, 0), ("224^3 modality 0 repeat", vol_a, 0)]
    totals = dict.fromkeys(PER_WINDOW, 0)
    outs = []
    for label, vol, mod in requests:
        windows = len(window_starts(vol.shape[1:-1], cfg.roi, cfg.infer_overlap)[1])
        torch.cuda.synchronize()
        fn.stats_launches = fn.apply_launches = fn.apply2_launches = fn.fold_launches = 0
        fc.launches = wa.launches = 0
        t0 = time.perf_counter()
        out = served.predict(vol, [mod])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {"K1": fn.stats_launches, "K2": fn.apply_launches,
                  "K3": fn.apply2_launches, "K4": fc.launches, "K5": wa.launches,
                  "K1 fold": fn.fold_launches}
        check(tuple(out.shape) == (*vol.shape[:-1], cfg.out_channels),
              f"serve {label}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"serve {label}: non-finite logits")
        for k, per in PER_WINDOW.items():
            check(counts[k] == per * windows,
                  f"serve {label}: {k} launched {counts[k]} times, want {per} x {windows}")
            totals[k] += counts[k]
        outs.append(out)
        print(f"  request {label}: {windows} windows, {sec:.3f} s, "
              f"{windows / sec:.2f} windows/s, launches {counts}, "
              f"|logits| <= {float(out.abs().max()):.3f}")
    rep = max_err(outs[3], outs[0])
    rep_tol = 1e-3 * (1.0 + float(outs[0].abs().max()))
    check(rep <= rep_tol, f"serve: repeated request differs by {rep:.3e} > {rep_tol:.3e}")
    print(f"serve: {len(requests)} full-width bf16 requests answered; repeat "
          f"max |diff| {rep:.3e} (tol {rep_tol:.3e}); launches per window {PER_WINDOW}")
    compare_paths(served, cfg, dev)
    profile_window(served, dev)
    return totals


def compare_paths(served, cfg, dev, reps: int = 10) -> None:
    """One 96^3 bf16 window through the served (fused conv chain) model and
    through an unfused model with the same weights: CUDA-event ms of each,
    timed in turns, and the max |diff| of their logits."""
    from miseg_tpu_torch.models import model_from_config

    unfused = model_from_config(cfg, device=dev, dtype=torch.bfloat16, fused_conv=False)
    unfused.load_state_dict(served.model.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(4)
    window = torch.rand((1, 96, 96, 96, 1), generator=gen).to(dev, torch.bfloat16)
    mods = torch.tensor([1], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        fused_out = served.model(window, mods).float()
        plain_out = unfused(window, mods).float()
        models = {"fused": served.model, "unfused": unfused}
        ms = {"fused": [], "unfused": []}
        for name in ("fused", "unfused", "unfused", "fused"):   # in turns
            ms[name].append(time_ms(lambda: models[name](window, mods), reps=reps))
    diff = max_err(fused_out, plain_out)
    check(bool(torch.isfinite(fused_out).all()), "paths: non-finite fused logits")
    print(f"paths: one 96^3 bf16 window, ms by CUDA events (median of {reps}, two "
          f"turns): fused conv chain {ms['fused'][0]:.3f} / {ms['fused'][1]:.3f}, "
          f"unfused (cuDNN + K1/K2) {ms['unfused'][0]:.3f} / {ms['unfused'][1]:.3f}; "
          f"logits max |diff| {diff:.3e} (|logits| <= {float(plain_out.abs().max()):.3f})")
    del unfused


# kernel-name substrings -> group, first match wins
_GROUPS = [("K1", ("miseg_k1_",)), ("K2", ("miseg_k2_",)),
           ("K3", ("miseg_k3_",)), ("K4", ("miseg_k4_",)),
           ("K5", ("miseg_k5_", "window_attention_kernel")),
           ("conv (cuDNN)", ("conv", "xmma", "implicit", "cudnn", "fprop", "dgrad", "wgrad")),
           ("linear (GEMM)", ("gemm", "cutlass", "gemv")),
           ("copy/pad/cat/roll", ("copy", "cat", "pad", "roll", "index", "gather")),
           ("optimizer (foreach)", ("multi_tensor",)),
           ("softmax", ("softmax",)),
           ("reduce", ("reduce",)),
           ("elementwise", ("elementwise",))]


def kernel_groups(kernels, reps: int) -> tuple[dict, dict]:
    """(device ms a rep by kernel name, by `_GROUPS` group) of profiler
    events over `reps` repetitions."""
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    groups: dict[str, float] = {}
    for name, ms in by_name.items():
        low = name.lower()
        group = next((g for g, keys in _GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    return by_name, groups


def window_faults(kernels, reps: int) -> list[str]:
    """What is wrong with the device kernels of `reps` bf16 96^3 windows:
    every bf16 conv is one K4 kernel (the 12 below 48^3 the coarse one,
    encoder1's Cin = 1 conv the Cin = 1 one), every K1 call and every fold
    one CUDA K1 kernel, every K2 and K3 call one CUDA kernel (the
    templates' `<...>` is in their names only), and no retired kernel."""
    if not kernels:
        return ["the profiler recorded no device events"]
    faults = []
    retired = sorted({e.name for e in kernels if any(k in e.name for k in (
        "miseg_k4_splitk_reduce", "miseg_k4_conv_wmma", "miseg_k4_conv_fma",
        "miseg_k1_stats_partial", "miseg_k1_stats_merge", "miseg_k1_stats_fold"))})
    if retired:
        faults.append(f"the bf16 window launched {retired}")
    k4 = [e.name for e in kernels if "miseg_k4_" in e.name]
    coarse = sum("miseg_k4_conv_coarse" in n for n in k4)
    cin1 = sum("miseg_k4_conv_cin1" in n for n in k4)
    if not (len(k4) == PER_WINDOW["K4"] * reps and coarse == 12 * reps and cin1 == reps):
        faults.append(f"{len(k4) / reps} K4 kernels a window, {coarse / reps} coarse, "
                      f"{cin1 / reps} Cin = 1; want {PER_WINDOW['K4']}, 12 and 1")
    k1 = [e.name for e in kernels if "miseg_k1_" in e.name]
    cuda_k1 = sum("miseg_k1_stats<" in n or "miseg_k1_fold" in n for n in k1)
    if not (len(k1) == (PER_WINDOW["K1"] + PER_WINDOW["K1 fold"]) * reps
            and cuda_k1 == len(k1)):
        faults.append(f"{len(k1) / reps} K1 kernels a window, {cuda_k1 / reps} of them the "
                      f"CUDA statistics and fold kernels; "
                      f"want {PER_WINDOW['K1'] + PER_WINDOW['K1 fold']}")
    for key, cuda_name in (("K2", "miseg_k2_apply<"), ("K3", "miseg_k3_apply2<")):
        names = [e.name for e in kernels if f"miseg_{key.lower()}_" in e.name]
        cuda = sum(cuda_name in n for n in names)
        if not (len(names) == PER_WINDOW[key] * reps and cuda == len(names)):
            faults.append(f"{len(names) / reps} {key} kernels a window, {cuda / reps} of "
                          f"them the CUDA ones; want {PER_WINDOW[key]}")
    return faults


def profile_window(served, dev, reps: int = 3) -> None:
    """Where one 96^3 window's time goes: device time by kernel group over
    `reps` window forwards under torch.profiler, and the device idle share
    of the wall time.  Fails on any of `window_faults` in every session."""
    gen = torch.Generator().manual_seed(3)
    window = torch.rand((1, 96, 96, 96, 1), generator=gen).to(dev)
    mods = torch.tensor([0], dtype=torch.int32, device=dev)
    served(window, mods)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        served(window, mods)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / reps
    walls = []

    def windows():
        t0 = time.perf_counter()
        for _ in range(reps):
            served(window, mods)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / reps)

    kernels = profiled(windows, lambda ev: not window_faults(ev, reps))
    faults = window_faults(kernels, reps)
    check(not faults, f"profile ({len(walls)} sessions, window {event_ms:.2f} ms by CUDA "
                      f"events): " + "; ".join(faults))
    wall_ms = walls[-1]
    by_name, groups = kernel_groups(kernels, reps)
    busy = sum(groups.values())
    print(f"profile: one 96^3 window, bf16, {reps} reps: {event_ms:.2f} ms by CUDA events; "
          f"under the profiler {wall_ms:.2f} ms wall, {busy:.2f} ms device busy "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.1%}), {len(kernels) // reps} kernels; "
          f"profiler sessions {len(walls)}")
    print("  by group ms/window: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in top[:10] + [kv for kv in top[10:] if "miseg_k" in kv[0]]:
        print(f"  {ms:8.3f} ms  {name[:110]}")


def grad_tolerance(ref: torch.Tensor, dtype) -> float:
    """A gradient's tolerance against autograd through the plain version:
    f32 cases 1e-5 relative to its scale (summation order); bf16 cases
    two bf16 ulps of its largest element, for every gradient of the case
    (the two sides round f32 values that differ by the rounding of their
    bf16 forward outputs and cotangents once more: the plain version's
    autograd sums cotangents in bf16, rounds P's cotangent to bf16 in K5,
    and K4's conv VJP runs on f32 operands)."""
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return scale * 2.0 ** -6 + 1e-6 if dtype == torch.bfloat16 else 1e-5 * (1.0 + scale)


def grad_case(label: str, fn, plain, inputs, launched, dtype, gen, kink: bool = False) -> str:
    """One kernel's autograd Function on the card: `fn(*inputs)` under grad
    mode must launch its kernel (`launched()` rises by one) and give
    outputs with a `grad_fn`; the gradients of every float input for seeded
    random cotangents must match `torch.autograd.grad` through `plain` on
    the same inputs within `grad_tolerance`.

    `kink`: the output ends in a leaky-relu, whose derivative jumps at 0.
    Where the kernel's and the plain version's outputs lie on two sides of
    0 (a pre-activation within the forward's rounding of 0), the two
    backwards rightly take different branches: those elements are left out
    of the gradients shaped like the output, and there must be fewer than
    one in 10^5 of them."""
    def leaves():
        return [t.detach().clone().requires_grad_(t.is_floating_point())
                if isinstance(t, torch.Tensor) else t for t in inputs]

    ins, ref_ins = leaves(), leaves()
    before = launched()
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    check(launched() == before + 1, f"train {label}: the forward under grad mode launched "
                                    f"{launched() - before} kernels, want 1")
    check(all(o.grad_fn is not None for o in outs), f"train {label}: an output has no grad_fn")
    refs = plain(*ref_ins)
    refs = refs if isinstance(refs, tuple) else (refs,)
    cts = [torch.randn(o.shape, generator=gen).to(o.device, o.dtype) for o in outs]
    wrt = [t for t in ins if isinstance(t, torch.Tensor) and t.requires_grad]
    ref_wrt = [t for t in ref_ins if isinstance(t, torch.Tensor) and t.requires_grad]
    got = torch.autograd.grad(outs, wrt, cts)
    want = torch.autograd.grad(refs, ref_wrt, cts)
    worst, apart = 0.0, None
    if kink:
        apart = (outs[0] >= 0) != (refs[0] >= 0)
        n_apart = int(apart.sum())
        check(n_apart * 10 ** 5 < apart.numel(), f"train {label}: the kernel and the plain "
                                                 f"version put {n_apart} outputs on two sides of 0")
    for i, (g, r) in enumerate(zip(got, want)):
        if apart is not None and g.shape == apart.shape:
            g, r = g.masked_fill(apart, 0), r.masked_fill(apart, 0)
        e, tol = max_err(g, r), grad_tolerance(r, dtype)
        check(bool(torch.isfinite(g).all()), f"train {label}: input {i} gradient not finite")
        check(e <= tol, f"train {label}: input {i} gradient {e:.3e} > {tol:.3e}")
        worst = max(worst, e / tol)
    kinked = "" if apart is None else f"; {int(apart.sum())} outputs on two sides of 0 left out"
    return (f"  train {label}: {len(got)} gradients match autograd through the plain "
            f"version (worst err/tol {worst:.2f}; tol 2 bf16 ulps of each gradient's max"
            f"{kinked})")


def train_functions(dev) -> None:
    """(a) Each kernel's autograd Function on the card in bf16 at a main-path
    shape against autograd through its plain version."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    from miseg_tpu_torch.ops.window import window_region_ids

    gen = torch.Generator().manual_seed(6)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0, mean=0.0, dtype=bf):
        return (mean + scale * torch.randn(shape, generator=gen)).to(dev, dtype)

    lines = []
    # K1 (x -> f32 columns, [2, 48] banks) and K2 (with its add) at [1, 48^3, 48]
    x, add = rnd((1, 48 ** 3, 48), 1.5, 0.3), rnd((1, 48 ** 3, 48))
    banks = (rnd((2, 48), 0.2, 1.0), rnd((2, 48), 0.2))
    styles = torch.tensor([1], dtype=torch.int32, device=dev)
    lines.append(grad_case(
        "K1 [1,48^3,48] banks", lambda x_, g_, b_: fn.channel_scale_shift(x_, g_, b_, styles),
        lambda x_, g_, b_: fn.channel_scale_shift_plain(x_, g_, b_, styles), [x, *banks],
        lambda: fn.stats_launches, bf, gen))
    cols = (rnd((1, 48), 0.3, 1.0, torch.float32), rnd((1, 48), 0.3, 0.0, torch.float32))
    lines.append(grad_case(
        "K2 [1,48^3,48] with add",
        lambda x_, s_, h_, a_: fn.apply_scale_shift(x_, s_, h_, a_, negative_slope=0.01),
        lambda x_, s_, h_, a_: fn.apply_scale_shift_plain(x_, s_, h_, a_, negative_slope=0.01),
        [x, *cols, add], lambda: fn.apply_launches, bf, gen, kink=True))
    # K3 at [1, 96^3, 48]
    x3, r3 = rnd((1, 96, 96, 96, 48)), rnd((1, 96, 96, 96, 48))
    c4 = [rnd((1, 48), 0.3, m, torch.float32) for m in (1.0, 0.0, 1.0, 0.0)]
    lines.append(grad_case(
        "K3 [1,96^3,48]",
        lambda x_, a, b, r_, c, d: fn.apply_norm2_act(x_, a, b, r_, c, d, negative_slope=0.01),
        lambda x_, a, b, r_, c, d: fn.apply_norm2_act_plain(x_, a, b, r_, c, d,
                                                            negative_slope=0.01),
        [x3, c4[0], c4[1], r3, c4[2], c4[3]], lambda: fn.apply2_launches, bf, gen, kink=True))
    del x, add, x3, r3
    # K4 with a prologue (brick 96^3, coarse 12^3 and 6^3) and the Cin = 1 call
    for label, shape, cout, prologue in (("96^3 48->48", (1, 96, 96, 96, 48), 48, True),
                                         ("12^3 192->192", (1, 12, 12, 12, 192), 192, True),
                                         ("6^3 384->384", (1, 6, 6, 6, 384), 384, True),
                                         ("Cin = 1 96^3 1->48", (1, 96, 96, 96, 1), 48, False)):
        cin = shape[-1]
        xk = rnd(shape, 1.0, 0.2)
        w = rnd((cout, cin, 3, 3, 3), (27 * cin) ** -0.5)
        g, b = rnd((2, cout), 0.2, 1.0), rnd((2, cout), 0.2)
        if prologue:
            sc, sh = rnd((1, cin), 0.3, 1.0, torch.float32), rnd((1, cin), 0.3, 0.0, torch.float32)
            call = lambda f: lambda x_, w_, g_, b_, sc_, sh_: f(  # noqa: E731
                x_, w_, sc_, sh_, slope=0.01, gamma=g_, beta=b_, styles=styles)
            args = [xk, w, g, b, sc, sh]
        else:   # encoder1: x is the image, which takes no gradient
            call = lambda f: lambda w_, g_, b_: f(  # noqa: E731
                xk, w_, gamma=g_, beta=b_, styles=styles)
            args = [w, g, b]
        lines.append(grad_case(f"K4 {label}", call(fc.conv3_norm_columns),
                               call(fc.conv3_norm_columns_plain), args,
                               lambda: fc.launches, bf, gen))
    # K5 at stage 1: [343, 343, 48], heads 3, with and without the mask
    qkv = rnd((343, 343, 144))
    bias = rnd((3, 343, 343), 1.0, 0.0, torch.float32)
    ids = window_region_ids((49, 49, 49), (7, 7, 7), (3, 3, 3), device=dev)
    for mask in (None, ids):
        split = lambda f, m=mask: lambda qkv_, b_: f(  # noqa: E731
            qkv_[..., :48], qkv_[..., 48:96], qkv_[..., 96:], b_, m, num_heads=3)
        lines.append(grad_case(
            f"K5 [343,343,48] h3 {'mask' if mask is not None else 'no mask'}",
            split(wa.window_attention), split(wa.window_attention_plain), [qkv, bias],
            lambda: wa.launches, bf, gen))
    print("\n".join(lines))


def train_card_vs_cpu(dev, size: int = 64) -> None:
    """(b) One f32 AdamW step of the fs-48 model at `size`^3, batch 1, on
    the card against the same step in the port on the CPU: loss within
    1e-5, every gradient leaf within 5e-5 and their sum within 1e-3, the
    parameters after the step within rtol 1e-4 / atol 2.5e-4 (the bounds
    the CPU tests hold the port to against JAX)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    cfg = Config(**{**FLAGSHIP, "roi_x": size, "roi_y": size, "roi_z": size, "no_amp": True})
    gen = torch.Generator().manual_seed(7)
    batch = {"image": torch.randn((1, size, size, size, 1), generator=gen),
             "label": torch.randint(0, cfg.out_channels, (1, size, size, size), generator=gen),
             "modality": torch.tensor([1], dtype=torch.int32)}
    cpu = Trainer(cfg, device="cpu")
    card = Trainer(cfg, device=dev)
    states = {"cpu": cpu.init_state(), "card": card.init_state(cpu.model.state_dict())}
    losses, took = {}, {}
    for name, trainer in (("cpu", cpu), ("card", card)):
        t0 = time.perf_counter()
        states[name], loss = trainer.train_step(states[name], batch)
        losses[name] = float(loss)
        took[name] = time.perf_counter() - t0
    loss_err = abs(losses["card"] - losses["cpu"])
    check(loss_err <= 1e-5, f"train step {size}^3: card vs CPU loss {loss_err:.3e} > 1e-5")
    gaps, worst_p = {}, 0.0
    for n, p in states["cpu"].params.items():
        q = states["card"].params[n]
        check(q.grad is not None, f"train step {size}^3: {n} has no gradient on the card")
        gaps[n] = max_err(q.grad.cpu(), p.grad)
        d = (q.detach().cpu() - p.detach()).abs() - (2.5e-4 + 1e-4 * p.detach().abs())
        worst_p = max(worst_p, float(d.max()))
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= 5e-5 and sum(gaps.values()) <= 1e-3,
          f"train step {size}^3: gradient gap worst {worst} {gaps[worst]:.3e} (tol 5e-5), "
          f"summed {sum(gaps.values()):.3e} (tol 1e-3)")
    check(worst_p <= 0.0, f"train step {size}^3: parameters after the step exceed "
                          f"rtol 1e-4 / atol 2.5e-4 by {worst_p:.3e}")
    print(f"  train step fs48 {size}^3 f32 (TF32 off), card vs CPU: loss {losses['card']:.6f} "
          f"|diff| {loss_err:.2e} (tol 1e-05); gradient gap over {len(gaps)} leaves summed "
          f"{sum(gaps.values()):.3e} (tol 1e-03), worst {worst} {gaps[worst]:.2e} (tol 5e-05); "
          f"parameters after one AdamW step within rtol 1e-4 / atol 2.5e-4; "
          f"step {took['card']:.2f} s card (first call), {took['cpu']:.1f} s CPU")


def synthetic_case(size: int, classes: int, gen):
    """A seeded image and label: concentric shells around the centre, one
    class a shell, and an image that is the label plus noise."""
    ax = torch.arange(size, dtype=torch.float32) - (size - 1) / 2
    r = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
    label = (r / (size / (2 * classes))).long().clamp(max=classes - 1)[None]
    image = label.float()[..., None] / classes + 0.1 * torch.randn((1, size, size, size, 1),
                                                                   generator=gen)
    return image, label


def train_full(dev, card: str, warmup: int = 2, steps: int = 10) -> dict:
    """(c) The flagship's training step at full width: 96^3, batch 1, bf16
    compute with f32 masters, AdamW, `dice_focal`, on one fixed seeded
    batch.  Returns the launches of each kernel in one step."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    from miseg_tpu_torch.train.engine import Trainer

    cfg = Config(**FLAGSHIP)
    gen = torch.Generator().manual_seed(8)
    image, label = synthetic_case(96, cfg.out_channels, gen)
    batch = {"image": image.to(dev), "label": label.to(dev),
             "modality": torch.tensor([0], dtype=torch.int32, device=dev)}
    trainer = Trainer(cfg, device=dev)
    check(trainer.compute_dtype == torch.bfloat16, "train: the flagship does not compute in bf16")
    state = trainer.init_state()
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        if i == 0:
            fn.stats_launches = fn.apply_launches = fn.apply2_launches = fn.fold_launches = 0
            fc.launches = wa.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = trainer.train_step(state, batch)
        end.record()
        if i == 0:
            counts = {"K1": fn.stats_launches, "K2": fn.apply_launches,
                      "K3": fn.apply2_launches, "K4": fc.launches, "K5": wa.launches,
                      "K1 fold": fn.fold_launches}
        end.synchronize()
        losses.append(float(loss))
        if i >= warmup:
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    check(counts == PER_WINDOW, f"train: one step launched {counts}, want {PER_WINDOW}")
    check(all(math.isfinite(v) for v in losses), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses[0]:.5f} -> {losses[-1]:.5f}")
    bad = [n for n, p in state.params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
    check(not bad, f"train: {len(bad)} parameters with a missing, non-finite or zero "
                   f"gradient, e.g. {bad[:3]}")

    walls = []

    def one_step():
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    kernels = profiled(one_step, lambda ev: not window_faults(ev, 1))
    faults = window_faults(kernels, 1)
    check(not faults, "train profile: " + "; ".join(faults))
    by_name, groups = kernel_groups(kernels, 1)
    busy = sum(groups.values())
    print(f"  train step fs48 96^3 bf16 (f32 masters), batch 1, AdamW, dice_focal on '{card}': "
          f"{statistics.median(ms):.2f} ms a step by CUDA events (median of {steps} after "
          f"{warmup} warm-up; min {min(ms):.2f}, max {max(ms):.2f}); one profiled step "
          f"{walls[-1]:.2f} ms wall, {busy:.2f} ms device busy (idle share "
          f"{max(0.0, 1 - busy / walls[-1]):.1%}), {len(kernels)} kernels; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    print("    by group ms a step: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.3f} ms  {name[:110]}")
    print(f"  loss by step: {' '.join(f'{v:.4f}' for v in losses)}; forward launches a step "
          f"{counts}; all {len(state.params)} parameters have finite, non-zero gradients")
    return counts


def phase_train(dev, card: str) -> dict:
    """Training on the card: (a) each kernel's autograd Function against
    autograd through its plain version, (b) one f32 step against the CPU,
    (c) the full-width bf16 step.  Returns the launches a step."""
    t0 = time.perf_counter()
    train_functions(dev)
    train_card_vs_cpu(dev)
    counts = train_full(dev, card)
    print(f"train: the kernels' Functions match autograd through their plain versions; the "
          f"card's f32 step matches the CPU's; the full-width bf16 step runs every kernel "
          f"under autograd ({time.perf_counter() - t0:.1f} s)")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py needs a CUDA card",
              file=sys.stderr)
        return 1
    # every f32 comparison is against full-precision f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = phase_device()
    mem_bw, bf16_flops, peak_name = card_peaks(card)
    print(f"  bounds use {peak_name} peaks: {mem_bw / 1e12:.2f} TB/s, "
          f"{bf16_flops / 1e12:.0f} TFLOP/s bf16")
    rows = phase_kernels(dev, mem_bw, bf16_flops)
    phase_model(dev)
    launches = phase_serve(dev)
    train = phase_train(dev, card)
    meta = {
        "K1": ("fused_norm.channel_scale_shift", "cuda",
               "miseg_tpu_torch/ops/kernels/csrc/fused_norm.cu",
               "miseg_tpu/ops/pallas/fused_norm.py:78"),
        "K1 fold": ("fused_norm.fold_partials", "cuda",
                    "miseg_tpu_torch/ops/kernels/csrc/fused_norm.cu",
                    "miseg_tpu/ops/pallas/fused_norm.py:78"),
        "K2": ("fused_norm.apply_scale_shift (times at [1,48^3,48])", "cuda",
               "miseg_tpu_torch/ops/kernels/csrc/norm_apply.cu",
               "miseg_tpu/ops/pallas/fused_norm.py:90"),
        "K3": ("fused_norm.apply_norm2_act", "cuda",
               "miseg_tpu_torch/ops/kernels/csrc/norm_apply.cu",
               "miseg_tpu/ops/pallas/fused_norm.py:278"),
        "K4": ("fused_conv.conv3_norm_columns", "cuda",
               "miseg_tpu_torch/ops/kernels/csrc/fused_conv.cu",
               "miseg_tpu/ops/pallas/fused_conv.py:49"),
        "K5": ("window_attention.window_attention", "cuda",
               "miseg_tpu_torch/ops/kernels/csrc/window_attention.cu",
               "miseg_tpu/ops/pallas/window_attention.py:64"),
    }
    # the JAX VJP each kernel's autograd Function follows (all jnp there)
    backward = {
        "K1": "miseg_tpu/ops/pallas/fused_norm.py:441 _stats_p_bwd + norm_columns :181",
        "K1 fold": "inside K4's Function: miseg_tpu/ops/pallas/fused_conv.py:173 _fconv_bwd",
        "K2": "miseg_tpu/ops/pallas/fused_norm.py:352 _apply1_bwd (+ d_add, _fin_bwd :240)",
        "K3": "miseg_tpu/ops/pallas/fused_norm.py:314 _apply2_bwd",
        "K4": "miseg_tpu/ops/pallas/fused_conv.py:173 _fconv_bwd",
        "K5": "miseg_tpu/ops/pallas/window_attention.py:166 _fwa_bwd",
    }
    kernels = []
    for key, (name, route, source, replaces) in meta.items():
        check(launches[key] > 0, f"{key} was never launched on the main path")
        check(train[key] > 0, f"{key} was never launched in the train step")
        kernels.append({"name": f"{key} {name}", "route": route, "source": source,
                        "replaces": replaces, "launches": launches[key], **rows[key],
                        "train": {"launches_per_step": train[key],
                                  "backward": backward[key]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
