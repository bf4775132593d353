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
               `torch.var_mean` / `F.conv3d`) at each shape, K1-K3 with
               L2 flushed before each call (their operands come from HBM,
               as their byte bounds assume) and, where the operands fit
               in L2, back to back as well (labelled L2-resident); and
               the host time of one wrapper call of each kernel at a
               small shape;
  3. model   — one full-width (feature_size 48, heads 3) window in f32,
               card against CPU, through the fused conv chain (the
               default) and through the unfused path (`fused_conv=False`);
  4. serve   — the full-width C-Swin-UNETR (seeded random weights, bf16,
               96^3 ROI, gaussian blend, overlap 0.5) exported on the CPU
               as a version-3 bundle (`serve.export_bundle`: the window
               forward through `torch.export`, every kernel a `miseg::` op
               in it) with 224^3 and 160x192x128 volume programs, once
               with the weights as arguments and once baked, and served on
               the card: in each form four requests eagerly (the generic
               inferer over the window program run as it is; the launch
               counters must rise by the per-window counts), through the
               served window (one CUDA graph of a window, replayed for
               each window) and through the volume programs captured as
               CUDA graphs (each captured answer against eager within the
               repeat tolerance; a replay launches nothing from Python,
               and a profiled 224^3 request through the window graph and
               a profiled replay of each volume program must run
               `PER_WINDOW` x windows kernels by name), with seconds and
               windows/s of all three, capture times, the 224^3 device
               busy time and idle share of both graphs, and memory with
               and without the graphs and after the bundle is dropped.
               Then one window through the fused and the unfused model
               (same weights), and profiles of one served (replayed) and
               one uncaptured window, each of which fails
               unless the window ran 20 K4 kernels (12 coarse, one Cin = 1,
               none on the FMA path or its split-K reduce), 51 K1 kernels
               (31 statistics, 20 folds), 29 K2 and 6 K3 kernels, all of
               them the CUDA ones; `load_bundle` plus the first window of a
               version-3 bundle against a version-2 one; the exported
               window programs of C-UNETR, C-UNet and UNetVanilla against
               their live models; and one 96^3 SSLHead ("vae") forward in
               bf16 on the card against the CPU in f32, K5 launching;
  5. serve_http — the serving-from-disk path over a real socket: the same
               flagship bundle, exported with the CT's preprocessed shape
               as a volume program, behind `cli.serve.make_server`
               (kernels and resampler built, one window run before it
               listens), a CT-like scan (512x512x200 int16, 0.4x0.4x0.6 mm,
               LPS, 32 windows) and an MR-like one (256x256x128 float32,
               1.2x1.2x1.5 mm, 108 windows) written as .nii.gz from a seed
               and POSTed: GET /health, a 404 and an empty POST's JSON 400;
               each answer a uint16 NIfTI in the scan's own grid with
               exactly its affine, voxel for voxel the in-process pipeline
               (chain -> predict -> argmax -> inverse), classes 0..5 or the
               MM-WHS values with remap=whs; the CT's requests replaying
               its captured volume program and the MR's replaying the
               window graph once a window (no launch from Python; a served
               MR predict runs PER_WINDOW x windows kernels by name under
               the profiler); predict under inference
               mode in a handler thread with logits that need no gradient
               and no autograd Function run; the two scans at once (the
               CT's with remap=whs; a serial CT request before them was
               cut to pay for the spatial phase's model steps); a line a
               request with seconds of
               upload+decode, preprocess, device predict, argmax+copy,
               inverse, encode and total, and windows/s;
  6. train   — training through `train.engine.Trainer`: (a) each kernel's
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
               profiled step, peak memory);
  7. fit     — a training run through `cli.train.main`: the flagship at
               full width (bf16, batch 1) fits 3 epochs of one 96^3 crop a
               volume on a synthetic CT + MR set (192x192x160 at 1.0 mm, 6
               classes, 2 train / 1 val / 1 test volumes a modality,
               written by `data/synthetic.py`) with a validation every
               epoch and warmup_cosine, tests best.ckpt (Dice, surface
               distance), resumes a 4th epoch from last.ckpt, and
               `cli.test.main` evaluates best.ckpt; every train step
               launches one window's kernels, every evaluate PER_WINDOW x
               its windows with no autograd Function; metric names, finite
               values, checkpoints and the resumed epoch, step and lr are
               checked, and `evaluate` of the fs-48 model at 64^3 in f32
               matches the CPU's; ms a step (p50, p95), the loader wait,
               epoch, validation and test seconds, peak memory;
  8. unetr   — C-UNETR, the JAX package's default model, at the full
               width of scripts/bench_unetr.py (feature_size 16, hidden
               768, mlp 3072, 12 heads, 12 blocks, perceptron patchify,
               `instance_cond` encoder/ViT norms): (a) K4 at its ten conv
               geometries, K1 + K2 at the ViT's [1,216,768], K2's add
               and K3 at its tails, against the plain versions in bf16
               and f32, with times; (b) the 64^3 f32 model card vs CPU on
               both conv paths; (c) a bf16 bundle serving a 224^3 volume
               (64 windows) with `UNETR_PER_WINDOW` x 64 launches and a
               profiled window that ran exactly those kernels; (d) its
               96^3 bf16 train step as `phase_train`'s (c); (e)
               `cli.train` for 2 epochs on `phase_fit`'s data set and
               `cli.test` of best.ckpt, with the launch, metric and
               Function checks of `phase_fit`.
  9. unet    — the residual UNets, whose norms run K1 + K2 alone (cuDNN
               convs, PReLU after K2): C-UNet (feature_size 16, the JAX
               package's UNet defaults, 13 norms a window) and UNetVanilla
               at the README's predict_whs recipe (16 64 128 256 512,
               strides 1 2 2 2 1, num_res_units 3, 8 classes, 32 norms):
               (a) K1 and K2 (no add, no activation, beside
               `torch.addcmul`) at every norm shape of their windows, C = 6
               at 96^3 to 512 at 12^3, against the plain versions in bf16
               and f32, with times; (b) both models at 64^3 in f32 card vs
               CPU, and a batch-norm C-UNet's train step (loss, gradients
               leaf by leaf, parameters, running statistics) and eval
               logits card vs CPU; (c) a bf16
               UNetVanilla bundle serving a 224^3 volume (64 windows) with
               `VANILLA_PER_WINDOW` x 64 launches, a C-UNet window with
               `CUNET_PER_WINDOW`, each with a profiled window running
               exactly those kernels; (d) both 96^3 bf16 train steps as
               `phase_train`'s (c); (e) `cli.train` of UNetVanilla for 2
               epochs on an 8-class synthetic set of `phase_fit`'s shape,
               `cli.test` of best.ckpt and `cli.predict_whs` over it.
 10. finetune — the flagship fine-tuned from existing weights, at full
               width: a MONAI-layout `model_swinvit.pt` written from a seed;
               `cli.train --model_name pre_swin_unetr --pre_swin <file>
               --use_checkpoint` for 2 epochs on `phase_fit`'s data set (the
               loaded swinViT tensors bitwise the file's, the `[2, C]` norm
               banks shape-skipped at init; each step's forward launching
               `PER_WINDOW` and its backward, the recompute,
               `RECOMPUTE_PER_STEP`: the kernels now run in the backward
               too); the fs-48 64^3 f32 step with dropout and drop-path,
               with recompute against without, card vs card; the 96^3 bf16
               step's peak memory at batch 2 with and without recompute;
               the fine-tuned best.ckpt written as a reference-layout
               Lightning .ckpt and tested by `cli.test` to the same
               metrics; a 224^3 volume stitched on the host against the
               device (peak memory, windows/s); the batch-size tuner
               stopped by a real out-of-memory error under a per-process
               memory fraction; a 12-step lr sweep.
 11. tune    — the hyper-parameter search (`cli.tune`) over the swin
               search space (feature_size 12/24/36 x heads 2/3/4, whose
               channels 12, 24, 36 and 72 the tensor-core kernels take
               padded to 16 in shared memory): (a) one pair a width
               (`SEARCH_PAIRS`: fs 12 h4, fs 24 h3, fs 36 h2, each head
               count once) from one seed, a 64^3 f32 window card vs CPU (K1-K5
               launching, K4 on its FMA path: f32 never takes TF32), then
               a bf16 bundle's 96^3 window launching `PER_WINDOW`,
               profiled, which fails unless its 20 K4 kernels are 12
               coarse, one Cin = 1 and the rest brick (`WINDOW_K4`, as the
               flagship's; no FMA kernel, no split-K reduce), with its
               busy and K4 device time; (b) K4 at 96^3 x 12 -> 12, 96^3 x
               36 -> 36, the Cin = 1 call to 12, 48^3 x 24 -> 24, 24^3 x
               72 -> 72 and the decoder's mixed 96^3 x 24 -> 12, 96^3 x
               48 -> 24, 96^3 x 72 -> 36 and 24^3 x 144 -> 72 in bf16
               (a repeat bit-identical), each launching its
               tensor-core kernel by name; K4's FMA kernel in f32 at
               96^3 x 12 -> 12 and 96^3 x 48 -> 48 timed against
               `F.conv3d` in f32 with TF32 off; and K5 at stage 1 with
               head dims 3, 9 and 18; all against their plain versions,
               timed against `F.conv3d` / SDPA and their bounds;
               (c) `cli.tune.main` of 2 trials (4 epochs, a validation
               each, warmup_cosine, bf16) on `phase_fit`'s data set, then
               a 1-trial resume of its journal: params.json against the
               journal, each trial's widths (parameter count), every
               kernel launching, device memory back at the baseline after
               each trial, the dashboard's report, the states against the
               pruner's rule; a line a trial (params, best Dice, state,
               seconds by part, step ms p50, peak memory).
 12. two_d   — 2-D models (`spatial_dims=2`) at full width: the flagship's
               C-Swin-UNETR on 96x96 slices (fs 48, heads 3/6/12/24, 7x7
               windows) and C-UNet: (a) K5 at the 2-D stage 1 (N = 49,
               head dim 16, with and without the shifted window's ids)
               and stage 4 (a clipped 6x6 window, N = 36), and K1, K2 and
               K3 at [1,96^2,48], against their plain versions, timed
               against their bounds and SDPA / `torch.var_mean`; (b) one
               f32 forward of each, batch 2, card against CPU, launching
               `TWO_D_PER_WINDOW` / `CUNET_PER_WINDOW`; (c) a bf16 2-D
               bundle serving a 512x512 slice (100 windows, gaussian,
               overlap 0.5) eagerly (the counters rise by the per-window
               counts) and through the window graph (within the repeat
               tolerance of eager; the profiled request runs the counts
               by name, K5 the tensor-core kernel, no K4), with ms a
               window and windows/s; (d) one f32 AdamW step card vs CPU
               under the 3-D check's bounds, and the bf16 full-width step.
 13. ddp     — data parallelism, ranks as subprocesses with timeouts: (a)
               NCCL at world 1, three flagship 96^3 bf16 steps through
               the wrapped Trainer against the unwrapped one (losses and
               parameters within the repeat tolerance, NCCL's all-reduce
               kernels in the profile, the step times of both); (b) two
               gloo ranks on the one card, one f32 step of the batch-norm
               UNetVanilla (README recipe) at batch 1 a rank against this
               process at batch 2 (gradients, parameters, running
               statistics); (c) the same two ranks' `make_inferer` of the
               flagship (96^3 ROI, bf16) on a 192x192x160 volume, its
               window groups fanned out over the ranks: the logits bitwise
               equal to this process's, each rank launching `PER_WINDOW`
               x its ceil(G/2) windows.
 14. mesh    — FSDP and tensor parallelism, two gloo ranks sharing the
               card: (a) one f32 step of the flagship's model at fs 24,
               64^3, under FSDP [2], TP [1, 2] and TP + FSDP [1, 2] against
               this process on the global batch (loss, gradients leaf by
               leaf, parameters); (b) the full-width flagship in bf16 under
               FSDP [2]: losses and parameters against one process, each
               step's launches `PER_WINDOW` (counted and by name in a
               profiled step), the bytes of masters and moments a rank.
 15. pipeline — GPipe pipeline parallelism (`parallel/pipeline.py`), gloo
               ranks sharing the card, the ("data", "pp") meshes `[1, 4]`
               (C-Swin-UNETR's four swin stages) and `[1, 2]` (C-UNETR's
               12 ViT blocks, 6 a stage): (a) one f32 step of the
               flagship's model at fs 24, 64^3, and of C-UNETR at 64^3,
               batch 2, two microbatches, against this process on the
               batch (loss, gradients leaf by leaf, W5); (b) the flagship
               at full width in bf16, batch 2, two microbatches: the losses
               of `MESH_STEPS` steps against one process, the parameters
               after the first within W5, every rank's masters bitwise
               equal, each rank's launches its stage's (`pp_launches`:
               the stage's blocks once a microbatch, the last stage's
               decoder once), counted and by name in a profiled step, with
               each rank's step ms, device busy time and peak memory; (c)
               C-UNETR at full width the same way on `[1, 2]`; beside FSDP
               and tensor parallelism (`PP_MESH_CASES`, in the `[1, 4]`
               leg's four ranks): (d) one f32 step of C-UNETR at its own
               width, 64^3 (`PP_UNETR_SMALL`, (c)'s f32 model), on
               ("data", "pp") `[2, 2]` with FSDP on "data", of the fs 24
               swin on `[1, 4]` with FSDP on "pp" and of C-UNETR on
               ("data", "model", "pp") `[1, 2, 2]` with TP + FSDP on
               "model", each held as (a), the masters bitwise equal over
               every rank; (e) the flagship in bf16 on `[1, 4]`
               with FSDP on "pp": `PP_FSDP_STEPS` steps held as (b), with
               each rank's masters plus moments, step ms, device busy and
               peak beside PP alone's.
 16. spatial — spatial partitioning (`parallel/spatial.py`): (a) K4's
               D-halo mode at the flagship's sharded slabs (`SP_CONVS`:
               96^3 at sp [2] and [4] on the brick kernel, 24^3 on the
               coarse one, 12^3's 6-plane slab on the FMA kernel, encoder1's
               Cin = 1 call), each pair of edge flags against its plain
               version with the fold's moments mode, the kernel by name,
               timed beside the whole volume's call and `F.conv3d` on the
               halo'd slab; K1's and the fold's moments modes; (b) two gloo
               ranks sharing the card on the line `[2]`: one f32 step of
               C-UNet (fs 16) and of the flagship's model at fs 24, 64^3,
               batch 2, against this process (`check_ddp_step`), the
               masters bitwise equal on both ranks; (c) the flagship at
               full width in bf16, 96^3, batch 1, on `[2]`: the losses of
               `MESH_STEPS` steps within 1e-3 relative of one process, the
               parameters after the first within W5, the masters bitwise
               equal, each rank's launches a step `sp_launches(2)`
               (counted, modes apart, and by name in a profiled step, with
               K4's kernel of each call), the halo and merge collectives a
               step, and each rank's step ms and peak memory beside one
               process's; (d) the same line with FSDP on it
               (`fsdp_axis="sp"`): the fs 24 swin's f32 step as in (b),
               the flagship's bf16 steps as in (c) (launches
               `sp_launches(2)` a step, counted), with the bytes of
               masters and moments and the peak a rank beside SP alone's;
               (e) C-UNETR and UNetVanilla (the README recipe) at 96^3 and
               the 2-D flagship at 96x96, bf16, batch 1, two steps each
               on `[2]` under (c)'s gates, each rank's launches a step
               `sp_launches(2, model=...)` (counted, modes apart, and by
               name in a profiled step); (a) also holds C-UNETR's halo
               shapes (`SP_UNETR_CONVS`) and K1's moments mode at the 2-D
               flagship's top slab.
Then one JSON line of kernels (with each kernel's `miseg::` op, its
kernels in a replay of the captured 224^3 volume program, its launches a
train step, the JAX VJP its backward follows, its launches in the fit's train steps
and evaluations, and its launches in C-UNETR's, C-UNet's and
UNetVanilla's windows, steps and fits, and in the fine-tune's forward and
recompute a step and its fit, and in the tune study, with K4's and K5's
rows at the search space's shapes; K2's row times its leaky-relu
mode, and its field `no_add_no_activation` the UNets' mode beside
`torch.addcmul`; the 2-D launches and rows, K5's at N = 49; the
launches of a data-parallel step, of a rank's fanned-out volume, of an
FSDP step, of each stage of a pipeline step (without and with FSDP on
its line) and of a spatially partitioned step, without and with FSDP;
and rows of their own for the spatial modes, K4 halo, K1 moments and K1
fold moments), the seconds of each phase, the card line, and the ok line
last.  The kernels' build runs beside the writing of the later phases'
synthetic data sets and scans (`prepare_inputs`).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
# what the flagship's backward launches with `use_checkpoint`: it recomputes
# the modules the JAX package remats, each once.  The 8 swin blocks: two
# norms (one K1 run and one K2 launch each) and one K5 launch apiece (the
# patch mergings and proj_out sit outside them); the 10 UnetrBasic/UpBlocks:
# their UnetResBlocks' two K4 launches (each with its fold), and the tail,
# one K1 + one K3 for the 6 projected residuals, one K2 add for the 4
# identity ones.  Their transposed convs are cuDNN's.
RECOMPUTE_PER_STEP = {"K1": 16 + 6, "K2": 16 + 4, "K3": 6, "K4": 20, "K5": 8, "K1 fold": 20}
# how many of the flagship window's K4 launches take the coarse (24^3 and
# below) and the Cin = 1 kernel; the rest take the brick kernel
WINDOW_K4 = {"coarse": 12, "cin1": 1}
# one 96^3 window of C-UNETR (feature_size 16, hidden 768, 12 ViT blocks):
# its 8 UnetResBlocks (encoder1, encoder2's block0/block1, encoder3's
# block0, decoder5..decoder2) run two K4 launches each (16; encoder1's
# conv1 Cin = 1, the 24^3 and 12^3 ones coarse: encoder2's and encoder3's
# block0, decoder5, decoder4), then the tail: the 5 with a projected
# residual (encoder1, decoder5..decoder2) one K1 run and one K3 launch,
# the 3 with an identity residual one K2 launch in its add mode.  The 25
# ViT norms (2 a block and the final one, over the 216 tokens) are one K1
# run and one K2 launch each.  No window attention: K5 never runs.
UNETR_PER_WINDOW = {"K1": 30, "K2": 28, "K3": 5, "K4": 16, "K5": 0, "K1 fold": 16}
UNETR_WINDOW_K4 = {"coarse": 8, "cin1": 1}
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
# C-UNETR at full width: scripts/bench_unetr.py:25-31 (pos_embed is the
# Config default, "perceptron"), 6 classes as the flagship
UNETR = dict(model_name="unetr", out_channels=6, feature_size=[16], hidden_size=768,
             mlp_dim=3072, num_heads=12, roi_x=96, roi_y=96, roi_z=96,
             encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
             decoder_norm_name="instance", infer_overlap=0.5, sw_batch_size=1)
# the most voxels, as a share of the 64^3 card-vs-CPU check's, whose CPU
# top-two margin may lie within twice the logits' largest difference (the
# voxels whose argmax that check may not hold): about twice the share
# seen on the H100 (26 of 524,288)
TIE_SHARE = 1e-4
# the K4 calls of a C-UNETR window: (label, x shape, Cout, prologue), one
# line per distinct geometry (a conv2 applies norm1 + leaky on read)
UNETR_CONVS = [
    ("encoder1 conv1 (Cin = 1)", (1, 96, 96, 96, 1), 16, False),
    ("encoder1/decoder2 conv2", (1, 96, 96, 96, 16), 16, True),
    ("decoder2 conv1", (1, 96, 96, 96, 32), 16, False),
    ("encoder2 block1/decoder3 conv2", (1, 48, 48, 48, 32), 32, True),
    ("decoder3 conv1", (1, 48, 48, 48, 64), 32, False),
    ("encoder2 block0", (1, 24, 24, 24, 32), 32, True),
    ("encoder3 block0/decoder4 conv2", (1, 24, 24, 24, 64), 64, True),
    ("decoder4 conv1", (1, 24, 24, 24, 128), 64, False),
    ("decoder5 conv1", (1, 12, 12, 12, 256), 128, False),
    ("decoder5 conv2", (1, 12, 12, 12, 128), 128, True),
]
# one 96^3 window of C-UNet (feature_size 16: channels 32/64/128/256,
# strides 2/2/2, num_res_units 2, prelu, NDA, 6 classes): its 13 ADN norms
# are one K1 run and one K2 launch each, in K2's no-add, no-activation
# mode (the PReLU runs after it on its own): 8 `instance_cond` in the down
# path ([1,48^3,32], [1,24^3,64], [1,12^3,128] and the bottom's
# [1,12^3,256], 2 each) and 5 `instance` in the up path (the transposed
# `up` convs at [1,24^3,64], [1,48^3,32] and [1,96^3,6], the `up_ru` at
# [1,24^3,64] and [1,48^3,32]; the top `up_ru` is conv-only).  Its convs
# are cuDNN's: no K4 (and so no fold), no K3, no K5.
CUNET_PER_WINDOW = {"K1": 13, "K2": 13, "K3": 0, "K4": 0, "K5": 0, "K1 fold": 0}
# one 96^3 window of UNetVanilla at the README prediction recipe: 24
# `instance_cond` norms (6 a scale at [1,48^3,64], [1,24^3,128],
# [1,12^3,256] and [1,12^3,512]) and 8 `instance` ones (2 each at
# [1,12^3,256], [1,24^3,128], [1,48^3,64] and [1,96^3,16])
VANILLA_PER_WINDOW = {"K1": 32, "K2": 32, "K3": 0, "K4": 0, "K5": 0, "K1 fold": 0}
UNET_WINDOW_K4 = {"coarse": 0, "cin1": 0}
# a batch-norm C-UNet's f64 gradient leaf card vs CPU (64^3, batch 2),
# relative to the leaf's largest element, and absolute for the biases of
# convs feeding a norm, whose gradient is 0 up to the rounding of the
# norm's f32 statistics (<= 9e-8; every other leaf >= 1.3e-5).  In f32
# the deep levels' gradients (1e-5..1e-4 at this init) lie within the
# flagship's 5e-5 leaf bound of 0 and differ card vs CPU by up to 0.9% of
# their size (the card's f32 against f64: 0.9%; the CPU's: 0.2%); in f64
# the two sides agree within 2.6e-6 of each leaf's size (NVIDIA H100
# 80GB HBM3, 700.00 W; scripts/torch_grad_precision.py)
F64_GRAD_RTOL, F64_GRAD_ATOL = 1e-4, 1e-6
# every distinct norm shape of the two UNets' windows
UNET_NORM_SHAPES = [(1, 96 ** 3, 6), (1, 96 ** 3, 16), (1, 48 ** 3, 32), (1, 48 ** 3, 64),
                    (1, 24 ** 3, 64), (1, 24 ** 3, 128), (1, 12 ** 3, 128),
                    (1, 12 ** 3, 256), (1, 12 ** 3, 512)]
# C-UNet at the JAX package's defaults (num_layers 4, strides 2 2 2,
# num_res_units 2, prelu, NDA), feature_size 16, 6 classes as the flagship
CUNET = dict(model_name="unet", out_channels=6, feature_size=[16], roi_x=96, roi_y=96,
             roi_z=96, encoder_norm_name="instance_cond", decoder_norm_name="instance",
             infer_overlap=0.5, sw_batch_size=1)
# UNetVanilla at the README's predict_whs recipe (README.md:79-80)
VANILLA = dict(model_name="unet_vanilla", out_channels=8,
               feature_size=[16, 64, 128, 256, 512], strides=[1, 2, 2, 2, 1],
               num_res_units=3, roi_x=96, roi_y=96, roi_z=96,
               encoder_norm_name="instance_cond", decoder_norm_name="instance",
               infer_overlap=0.5, sw_batch_size=1)
L2_FLUSH_BYTES = 128 << 20
# (memory B/s, dense bf16 FLOP/s) from NVIDIA's data sheets
PEAKS = {"PCIe": (2.0e12, 756e12), "NVL": (3.9e12, 835e12),
         "SXM": (3.35e12, 989e12)}
# f32 FLOP/s outside the tensor cores, from the same data sheets
F32_PEAKS = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_key(name: str) -> str:
    return next((key for key in ("PCIe", "NVL") if key in name), "SXM")


def card_peaks(name: str) -> tuple[float, float, str]:
    key = card_key(name)
    return (*PEAKS[key], f"H100 {key}")


def l2_flush(dev):
    """A callable that overwrites 128 MB on the card, more than the H100's
    50 MB L2.  Run before each timed call, it leaves none of the call's
    operands in L2, so the call reads them from HBM and its time is
    comparable with a byte bound taken at HBM's rate."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    return buf.zero_


def time_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of `fn` in ms; with `flush`, `flush()` runs
    before each call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


MARK_CYCLES = 2_000_000   # ~1 ms of spin at the H100's clocks; the others spin 1000
MARK_US = 100.0


def profiled(run, ok, attempts: int = 3, lead=None, cpu: bool = True,
             settle: float = 0.005) -> list:
    """The device events torch.profiler records while `run()` runs, from the
    first of `attempts` sessions whose events satisfy `ok(events)`, else
    from the last.  The profiler misses kernels launched right after a
    session starts (and now and then a whole session's), so each session
    first runs ATen's `spin_kernel` (`torch.cuda._sleep`) and waits
    `settle` s on the host; with `lead`, it then runs `lead()` (a call like `run`'s,
    whose kernels take any such loss) and a second spin kernel, ~1 ms long
    (`MARK_CYCLES`, told apart from the others by its length), and only
    the events that start after that spin are `run()`'s; a session that
    lost that spin counts as one that failed `ok` (a session that lost
    the last spin once counted `lead()`'s kernels as `run()`'s).  A last
    spin kernel follows `run()`, so no kernel of its is the session's
    last.  Spin kernels are left out of the events; a kernel that
    launches wrongly fails every session.  Device-side user annotations (the optimizer's
    `Optimizer.step` range) are left out too: they span kernels that are
    counted on their own.  `cpu=False` records the device's activity
    alone: a multi-rank step's tens of thousands of host ops take seconds
    to collect, and only its kernels are read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for _ in range(attempts):
        with profile(activities=activities) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(settle)
            if lead is not None:
                lead()
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)   # run()'s last kernels are not the session's last
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        # the long spin after `lead()`: run()'s kernels start after it
        marks = [e.time_range.start for e in events if "spin_kernel" in e.name
                 and e.time_range.elapsed_us() > MARK_US]
        after = max(marks) if lead is not None and marks else float("-inf")
        events = [e for e in events
                  if "spin_kernel" not in e.name and e.time_range.start > after]
        if ok(events) and (lead is None or marks):
            break
    return events


def device_ms(fn, match: str | None = None, reps: int = 10, flush=None) -> float | None:
    """Device time of one call of `fn` in ms: the summed duration of its
    kernels (only those whose names hold `match`, if given; `match` leaves
    out the kernel of `flush`, which runs before each call) under
    torch.profiler, averaged over `reps` calls that follow a lead call of
    `fn` (`profiled`).  None where no session recorded at least `reps`
    such kernels: a sum over fewer calls is no time of one."""
    fn()
    torch.cuda.synchronize()

    def matching(events):
        return [e for e in events if match is None or match in e.name]

    def calls():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    events = matching(profiled(calls, lambda ev: len(matching(ev)) >= reps, lead=fn))
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


def reset_launches() -> None:
    """Set every kernel wrapper's launch counter to 0, the modes' of spatial
    partitioning (`mode_counts`) among them."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    fn.stats_launches = fn.apply_launches = fn.apply2_launches = fn.fold_launches = 0
    fn.moments_launches = fn.fold_moments_launches = fc.halo_launches = 0
    fc.launches = wa.launches = 0


def launch_counts() -> dict:
    """The launch counters by `PER_WINDOW` key."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa
    return {"K1": fn.stats_launches, "K2": fn.apply_launches, "K3": fn.apply2_launches,
            "K4": fc.launches, "K5": wa.launches, "K1 fold": fn.fold_launches}


def mode_counts() -> dict:
    """The launch counters of the spatial-partitioning modes: K1's and the
    fold's moments modes, K4's D-halo mode."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    return {"K1 moments": fn.moments_launches, "K1 fold moments": fn.fold_moments_launches,
            "K4 halo": fc.halo_launches}


# the synthetic CT + MR sets of the fits and the study (2 / 1 / 1 volumes a
# modality of `FIT_SHAPE` at 1 mm, seed 9; 6 classes, and UNetVanilla's 8)
# and the HTTP phase's two scans: CPU-only inputs of later phases, written
# in a thread while nvcc builds the kernels (`prepare_inputs`)
FIT_SHAPE = (192, 192, 160)
_PREPARED: dict = {}


def prepare_inputs() -> None:
    """Start writing the later phases' CPU-only inputs in a thread, into a
    temporary directory that lives until the process ends; `fit_data` and
    `http_scans` wait for them."""
    from miseg_tpu_torch.data.synthetic import make_synthetic_dataset

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    def write():
        try:
            t0 = time.perf_counter()
            for classes in (6, 8):
                make_synthetic_dataset(root / f"data{classes}", shape=FIT_SHAPE,
                                       num_classes=classes, n_train=2, n_val=1, n_test=1,
                                       spacing=(1.0, 1.0, 1.0), seed=9, suffix=".nii")
            (root / "scans").mkdir()
            _PREPARED["scans"] = synthetic_scans(root / "scans")
            _PREPARED["seconds"] = time.perf_counter() - t0
        except BaseException as e:   # raised where the inputs are asked for
            _PREPARED["error"] = e

    _PREPARED.update(tmp=tmp, root=root, thread=threading.Thread(target=write, daemon=True))
    _PREPARED["thread"].start()


def _prepared() -> Path | None:
    """The directory `prepare_inputs` wrote, once it is done (None when it
    never started); its error, re-raised."""
    if "thread" not in _PREPARED:
        return None
    _PREPARED["thread"].join()
    if "error" in _PREPARED:
        raise RuntimeError("writing the prepared inputs failed") from _PREPARED["error"]
    return _PREPARED["root"]


def fit_data(tmp, shape, classes: int) -> Path:
    """The fits' synthetic CT + MR set of `shape` with `classes` classes:
    the one `prepare_inputs` wrote where it matches (every phase only
    reads it), else written under `tmp` now."""
    from miseg_tpu_torch.data.synthetic import make_synthetic_dataset

    root = _prepared() if tuple(shape) == FIT_SHAPE and classes in (6, 8) else None
    if root is not None:
        return root / f"data{classes}"
    root = Path(tmp) / "data"
    make_synthetic_dataset(root, shape=shape, num_classes=classes, n_train=2, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=9, suffix=".nii")
    return root


def http_scans(root: Path) -> list[dict]:
    """`synthetic_scans`: the ones `prepare_inputs` wrote, else written
    under `root` now."""
    return _PREPARED["scans"] if _prepared() is not None else synthetic_scans(root)


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
    kernels = (("window_attention", "miseg_k5_attn_mma"), ("fused_conv", "miseg_k4_conv_brick"),
               ("fused_conv", "miseg_k4_conv_coarse"), ("fused_conv", "miseg_k4_conv_cin1"))
    # each library's SASS dumped once, both at once
    dumps = {source: subprocess.Popen([str(tool), "-sass", str(build.library_path(source))],
                                      stdout=subprocess.PIPE, text=True)
             for source in dict(kernels)}
    sasses = {source: p.communicate(timeout=120)[0] for source, p in dumps.items()}
    check(all(p.returncode == 0 for p in dumps.values()),
          f"cuobjdump exited {[p.returncode for p in dumps.values()]}")
    for source, kernel in kernels:
        sass = sasses[source]
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


def hbm_and_l2(fn, match: str, nbytes: int, flush, reps: int = 20) -> dict:
    """CUDA-event and device ms of `fn` with L2 flushed before each call
    ("hbm": the operands come from HBM, the time a byte bound is held
    against) and, where its `nbytes` fit in the 50 MB L2, back to back on
    the same operands ("l2": L2-resident, faster than HBM allows)."""
    out = {"hbm": (time_ms(fn, reps=reps, flush=flush), device_ms(fn, match, flush=flush))}
    if nbytes < 40e6:
        out["l2"] = (time_ms(fn, reps=reps), device_ms(fn, match))
    return out


def fmt_hbm_l2(times: dict) -> str:
    line = f"{times['hbm'][0]:.4f} (device {fmt_ms(times['hbm'][1])})"
    if "l2" in times:
        line += (f"; L2-resident {times['l2'][0]:.4f} (device "
                 f"{fmt_ms(times['l2'][1])})")
    return line


def k1_case(shape, dev, gen, mem_bw: float, flush, k2_ms: dict | None = None):
    """K1 at `shape` with `[2, C]` banks against its plain version in bf16
    and f32 (relative error 1e-5); in bf16 its times (`hbm_and_l2`), the
    plain version's and `torch.var_mean`'s beside its byte bound.  Returns
    (the lines, the bf16 `kernels` row)."""
    import torch.nn.functional as F

    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, s, c = shape
    lines, row = [], None
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
        lines.append(f"  K1 {list(shape)} {str(dtype)[6:]}: rel err {e1:.2e} (tol 1e-05)")
        if dtype != torch.bfloat16:
            continue
        nbytes = x.numel() * x.element_size()
        call = lambda: fn.channel_scale_shift(x, gamma, beta, styles)  # noqa: E731
        k1 = hbm_and_l2(call, "miseg_k1_", nbytes, flush)
        k1_plain = time_ms(lambda: fn.channel_scale_shift_plain(x, gamma, beta, styles))
        k1_lib = time_ms(lambda: torch.var_mean(x, dim=1, correction=0), flush=flush)
        dev_lib = device_ms(lambda: torch.var_mean(x, dim=1, correction=0), "reduce",
                            flush=flush)
        b1 = nbytes / mem_bw * 1e3
        line = (f"    times ms: K1 {fmt_hbm_l2(k1)} (bound {b1:.5f} by bytes), plain "
                f"{k1_plain:.4f}, torch.var_mean {k1_lib:.4f} (device {fmt_ms(dev_lib)})")
        side = round(s ** (1 / 3))
        if k2_ms is not None and shape in k2_ms and side ** 3 == s:
            xcf = x.reshape(b, side, side, side, c).permute(0, 4, 1, 2, 3)
            inorm = time_ms(lambda: F.instance_norm(xcf), flush=flush)
            line += (f"; K1+K2 {k1['hbm'][0] + k2_ms[shape]:.4f} vs F.instance_norm "
                     f"{inorm:.4f}")
        lines.append(line)
        row = dict(ms=k1["hbm"][0], plain_ms=k1_plain, bound_ms=b1, bound_by="bytes",
                   library_ms=k1_lib, max_abs_err=max(max_err(scale, rs), max_err(shift, rh)))
    return "\n".join(lines), row


def k2_case(shape, dev, gen, mem_bw: float, flush, adds=(False, True)):
    """K2 with its leaky-relu at `shape` (without and, with `adds` holding
    True, with its add) against its plain version in bf16 and f32; in
    bf16 its times (`hbm_and_l2`) beside its byte bound and the plain
    version's.  Returns (the line, the bf16 `kernels` row of K2 without
    its add, the HBM event ms of K2 without its add)."""
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, s, c = shape
    slope = 0.01
    line, timed, row, k2_hbm = f"  K2 {list(shape)}:", "", None, None
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
        add = torch.randn(shape, generator=gen).to(dev, dtype)
        sc = (1 + 0.3 * torch.randn((b, c), generator=gen)).to(dev)
        sh = (0.3 * torch.randn((b, c), generator=gen)).to(dev)
        errs = {}
        for a in (add if want else None for want in adds):
            y = fn.apply_scale_shift(x, sc, sh, a, negative_slope=slope)
            ref = fn.apply_scale_shift_plain(x, sc, sh, a, negative_slope=slope)
            e, tol = max_err(y, ref), tolerance(ref, dtype)
            check(e <= tol, f"K2 {shape} {dtype} add={a is not None}: {e:.3e} > {tol:.3e}")
            errs[a is not None] = e
            line += (f" {str(dtype)[6:]}{'+add' if a is not None else ''} err {e:.3e} "
                     f"(tol {tol:.3e});")
        if dtype != torch.bfloat16:
            continue
        nbytes, cols = x.numel() * x.element_size(), 2 * b * c * 4
        parts = []
        for with_add in adds:
            a = add if with_add else None
            moved = (3 if with_add else 2) * nbytes + cols
            call = lambda a=a: fn.apply_scale_shift(x, sc, sh, a, negative_slope=slope)  # noqa: E731
            times = hbm_and_l2(call, "miseg_k2_", moved, flush)
            label = "K2+add" if with_add else "K2"
            parts.append(f"{label} {fmt_hbm_l2(times)}, bound {moved / mem_bw * 1e3:.5f} by "
                         f"bytes")
            if not with_add:
                k2_hbm = times["hbm"][0]
                row = dict(ms=k2_hbm, plain_ms=None, bound_ms=moved / mem_bw * 1e3,
                           bound_by="bytes", library_ms=None, max_abs_err=errs[False])
        plain = time_ms(lambda: fn.apply_scale_shift_plain(x, sc, sh, None,
                                                            negative_slope=slope))
        if row is not None:
            row["plain_ms"] = plain
        timed = "\n    bf16 ms: " + "; ".join(parts) + f"; plain {plain:.4f}"
    return line + timed, row, k2_hbm


def k2_affine_case(shape, dev, gen, mem_bw: float, flush):
    """K2 in its no-add, no-activation mode (`x * scale + shift`, the UNets'
    norms) at `shape` against its plain version in bf16 and f32; in bf16
    its times (`hbm_and_l2`) beside its byte bound, the plain version's,
    and that of the one library call computing the same function,
    `torch.addcmul(shift, x, scale)` with `[B, 1, C]` columns in x's dtype
    (L2 flushed).  Returns (the line, the bf16 `kernels` row)."""
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, s, c = shape
    line, row = f"  K2 {list(shape)} (no add, no activation):", None
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
        sc = (1 + 0.3 * torch.randn((b, c), generator=gen)).to(dev)
        sh = (0.3 * torch.randn((b, c), generator=gen)).to(dev)
        y, ref = fn.apply_scale_shift(x, sc, sh), fn.apply_scale_shift_plain(x, sc, sh)
        e, tol = max_err(y, ref), tolerance(ref, dtype)
        check(e <= tol, f"K2 {shape} {dtype} (no add, no activation): {e:.3e} > {tol:.3e}")
        line += f" {str(dtype)[6:]} err {e:.3e} (tol {tol:.3e});"
        if dtype != torch.bfloat16:
            continue
        moved = 2 * x.numel() * x.element_size() + 2 * b * c * 4
        bound = moved / mem_bw * 1e3
        times = hbm_and_l2(lambda: fn.apply_scale_shift(x, sc, sh), "miseg_k2_", moved, flush)
        plain = time_ms(lambda: fn.apply_scale_shift_plain(x, sc, sh))
        sc3, sh3 = sc[:, None, :].to(dtype), sh[:, None, :].to(dtype)
        lib = time_ms(lambda: torch.addcmul(sh3, x, sc3), flush=flush)
        lib_dev = device_ms(lambda: torch.addcmul(sh3, x, sc3), "addcmul", flush=flush)
        k2_dev = times["hbm"][1]
        share = "not measured" if k2_dev is None else f"{bound / k2_dev:.0%}"
        line += (f"\n    bf16 ms: K2 {fmt_hbm_l2(times)}, bound {bound:.5f} by bytes "
                 f"(device time at {share} of the HBM roofline); plain {plain:.4f}; "
                 f"torch.addcmul {lib:.4f} (device {fmt_ms(lib_dev)})")
        row = dict(ms=times["hbm"][0], plain_ms=plain, bound_ms=bound, bound_by="bytes",
                   library_ms=lib, max_abs_err=e)
    return line, row


def k3_case(shape, dev, gen, mem_bw: float, flush, note: str = ""):
    """K3 at `shape` against its plain version in bf16 and f32; in bf16
    its times (`hbm_and_l2`) beside its byte bound and the plain
    version's.  Returns (the line, the bf16 `kernels` row)."""
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, s, c = shape
    slope = 0.01
    line, timed, row = f"  K3 {list(shape)}{note}:", "", None
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
        bound = (3 * x.numel() * x.element_size() + 4 * b * c * 4) / mem_bw * 1e3
        times = hbm_and_l2(call, "miseg_k3_", bound * mem_bw / 1e3, flush)
        plain = time_ms(lambda: fn.apply_norm2_act_plain(x, *cols[:2], res, *cols[2:],
                                                         negative_slope=slope))
        timed = (f"\n    bf16 ms: K3 {fmt_hbm_l2(times)}, bound {bound:.5f} by bytes; "
                 f"plain {plain:.4f}")
        row = dict(ms=times["hbm"][0], plain_ms=plain, bound_ms=bound, bound_by="bytes",
                   library_ms=None, max_abs_err=e)
    return line + timed, row


def k4_kernel_names(call, calls: int = 5, sessions: int = 10) -> list[str]:
    """The names of the K4 device kernels torch.profiler records over
    `calls` calls of `call` (after a lead call, `profiled`), in every
    session of up to `sessions` until one records a kernel a call: the
    profiler now and then loses a session's kernels (on some hosts every
    kernel of many sessions in a row), so one session that saw none
    proves nothing, while a wrong kernel in any session is a wrong route.
    After a session that saw none the next settles 100 ms before its lead
    call and makes 4 times the calls."""
    names, settle, n = [], 0.005, calls
    for i in range(sessions):
        def run(n=n):
            for _ in range(n):
                call()

        events = profiled(run, lambda ev: True, attempts=1, lead=call, settle=settle)
        seen = [e.name for e in events if "miseg_k4_" in e.name]
        names += seen
        if len(seen) == n:
            break
        if not seen:
            print(f"    (profiler session {i}: no K4 kernel among {len(events)} device "
                  f"events {sorted({e.name[:48] for e in events})[:4]})")
            settle, n = 0.1, 4 * calls
    return names


def k4_case(label: str, shape, cout: int, prologue: bool, dev, gen, mem_bw: float,
            bf16_flops: float, timed=torch.bfloat16, kernel: str | None = None,
            flops_peak: float | None = None):
    """K4 at x `shape` -> `cout` (with norm1's columns + leaky on read when
    `prologue`) against its plain version in bf16 and f32, its output and
    its epilogue's columns; in the `timed` dtype its CUDA-event and device
    times, the plain version's and `F.conv3d`'s (in f32 with TF32 off, as
    `main` sets it) beside its bound, whose operations count at
    `flops_peak` (default `bf16_flops`).  With `kernel`, every K4 device
    kernel the timed call launches must hold it in its name
    (`k4_kernel_names`).  Returns
    (the lines, the timed dtype's `kernels` row).  With `kernel`, a
    repeated call must also be bit-identical."""
    import torch.nn.functional as F

    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, cin = shape[0], shape[-1]
    s_vox = shape[1] * shape[2] * shape[3]
    lines, row = [], None
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen) / (27 * cin) ** 0.5).to(dev, dtype)
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
        # the epilogue's columns against the plain fold of the kernel's own
        # y: isolates the statistics from the conv's rounding
        rs, rh = fn.channel_scale_shift_plain(y.reshape(b, -1, cout), kw["gamma"],
                                              kw["beta"], kw["styles"])
        ec = max(max_err(sc, rs) / (1 + float(rs.abs().max())),
                 max_err(sh, rh) / (1 + float(rh.abs().max())))
        check(ec <= 1e-5, f"K4 {label} {dtype}: columns rel err {ec:.2e} > 1e-5")
        lines.append(f"  K4 {label} {list(shape)}->{cout} {str(dtype)[6:]}: err {e:.3e} "
                     f"(tol {tol:.3e}), columns rel err {ec:.2e} (tol 1e-05)")
        if dtype != timed:
            continue
        names = None
        if kernel is not None:
            names = k4_kernel_names(lambda: fc.conv3_norm_columns(x, w, **kw))
            check(bool(names) and all(kernel in n for n in names),
                  f"K4 {label} {dtype}: launched {sorted(set(names))}, want only {kernel}")
            again = fc.conv3_norm_columns(x, w, **kw)
            check(all(torch.equal(a, c) for a, c in zip((y, sc, sh), again)),
                  f"K4 {label} {dtype}: a repeated call is not bit-identical")
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
        peak = bf16_flops if flops_peak is None else flops_peak
        bound = max(nbytes / mem_bw, flops / peak) * 1e3
        by = "bytes" if nbytes / mem_bw >= flops / peak else "operations"
        if names is not None:
            lines.append(f"    {str(dtype)[6:]} kernel: {names[0][:90]}")
        lines.append(f"    times ms: K4 {k4:.4f} (bound {bound:.4f} by {by}: "
                     f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
                     f"{flops / k4 / 1e9:.1f} TFLOP/s), plain {plain:.4f}, "
                     f"F.conv3d {lib:.4f}"
                     f"\n    device ms: K4 kernel {fmt_ms(dev_k4)} (with its fold "
                     f"{fmt_ms(dev_call)}), F.conv3d {fmt_ms(dev_lib)}")
        row = dict(ms=k4, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                   max_abs_err=e, device_ms=dev_k4, library_device_ms=dev_lib)
        if names is not None:
            row["kernel"] = names[0]
    return "\n".join(lines), row


def k5_case(label: str, bw: int, n: int, c: int, heads: int, padded, dev, gen,
            mem_bw: float, bf16_flops: float, window=(7, 7, 7), device: bool = False):
    """K5 at `[bw, n, c]` with `heads` heads against its plain version in
    bf16 and f32, without and with region ids (those of a shifted `window`
    over `padded` dims, or random ones where `padded` is None); in bf16 its
    CUDA-event time (with the ids where `padded` is given), the plain
    version's and `F.scaled_dot_product_attention`'s beside its bound, and
    with `device` the device times of K5 and SDPA (`device_ms`; at small
    shapes an event time is the host's launch time).  Returns (the lines,
    the bf16 `kernels` row)."""
    import torch.nn.functional as F

    from miseg_tpu_torch.ops.kernels import window_attention as wa
    from miseg_tpu_torch.ops.window import window_region_ids

    lines, row = [], None
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn((bw, n, 3 * c), generator=gen).to(dev, dtype)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn((heads, n, n), generator=gen).to(dev)
        if padded is not None:
            real_ids = window_region_ids(padded, window, tuple(w // 2 for w in window),
                                         device=dev)
        else:  # an unshifted window; random regions still test the mask
            real_ids = torch.randint(0, 3, (bw, n), generator=gen, dtype=torch.int32).to(dev)
        line = f"  K5 {label} [{bw},{n},{c}] h{heads} {str(dtype)[6:]}:"
        errs = {}
        for ids in (None, real_ids):
            out = wa.window_attention(q, k, v, bias, ids, num_heads=heads)
            ref = wa.window_attention_plain(q, k, v, bias, ids, num_heads=heads)
            e, tol = max_err(out, ref), tolerance(ref, dtype)
            check(e <= tol, f"K5 {label} {dtype} ids={ids is not None}: {e:.3e} > {tol:.3e}")
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
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
            nbytes = (4 * bw * n * c * 2 + bias.numel() * 4
                      + (ids.numel() * 4 if ids is not None else 0))
            flops = 4 * bw * heads * n * n * hd
            bound = max(nbytes / mem_bw, flops / bf16_flops) * 1e3
            by = "bytes" if nbytes / mem_bw >= flops / bf16_flops else "operations"
            line += (f"\n    times ms: K5 {k5:.4f} (bound {bound:.4f} by {by}: "
                     f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {plain:.4f}, "
                     f"F.scaled_dot_product_attention {sdpa:.4f}")
            row = dict(ms=k5, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=sdpa,
                       max_abs_err=errs[ids is not None])
            if device:
                row["device_ms"] = device_ms(lambda: wa.window_attention(
                    q, k, v, bias, ids, num_heads=heads), "miseg_k5_")
                row["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask))
                line += (f"; device: K5 {fmt_ms(row['device_ms'])}, SDPA (all its kernels) "
                         f"{fmt_ms(row['library_device_ms'])}")
        lines.append(line)
    return "\n".join(lines), row


def phase_kernels(dev, mem_bw: float, bf16_flops: float) -> dict:
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa

    # every library loaded before the first profiler session: one first
    # loaded after a session showed no device events in later sessions
    fn._k1(), fn._k23(), fc._entry(), wa._lib()
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    flush = l2_flush(dev)
    rows, k2_ms = phase_norm_apply(dev, mem_bw, gen, flush)
    # K2's row stays its leaky-relu mode (the flagship's); the UNets' mode,
    # beside the one library call that computes it, is a field of its own
    line, affine = k2_affine_case((1, 48 ** 3, 48), dev, gen, mem_bw, flush)
    print(line)
    rows["K2"]["no_add_no_activation"] = {"shape": [1, 48 ** 3, 48], **affine}
    # ---- K1 at main-path norm shapes -------------------------------------
    for shape in [(1, 96 ** 3, 48), (1, 48 ** 3, 48), (1, 27, 3072)]:
        line, row = k1_case(shape, dev, gen, mem_bw, flush, k2_ms)
        print(line)
        if shape == (1, 96 ** 3, 48):
            rows["K1"] = row
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
        line, row = k5_case(f"stage {stage}", bw, n, c, heads, padded, dev, gen, mem_bw,
                            bf16_flops)
        print(line)
        if stage == 1:
            rows["K5"] = row
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
        line, row = k4_case(label, shape, cout, prologue, dev, gen, mem_bw, bf16_flops)
        print(line)
        if label == "encoder1/decoder1 conv2":
            rows["K4"] = row
    torch.cuda.synchronize()
    host_cost(dev)
    print(f"kernels: K1, K1 fold, K2, K3, K4, K5 match their plain versions at main-path "
          f"shapes in bf16 and f32 ({time.perf_counter() - t0:.1f} s)")
    return rows


def phase_norm_apply(dev, mem_bw: float, gen, flush) -> tuple[dict, dict]:
    """K2 (with and without its add) at `K2_SHAPES` and K3 at `K3_SHAPES`
    against their plain versions in bf16 and f32, with CUDA-event and
    device times (from HBM, and L2-resident where the operands fit) and
    byte bounds in bf16.  Returns the `kernels` rows of K2 (at [1, 48^3,
    48], its largest served shape) and K3 (at [1, 96^3, 48]), and K2's
    HBM event ms by shape."""
    rows, k2_ms = {}, {}
    for shape in K2_SHAPES:
        line, row, k2_ms[shape] = k2_case(shape, dev, gen, mem_bw, flush)
        print(line)
        if shape == (1, 48 ** 3, 48):
            rows["K2"] = row
    for shape in K3_SHAPES:
        note = " (off the served path)" if shape in K3_OFF_PATH else ""
        line, row = k3_case(shape, dev, gen, mem_bw, flush, note)
        print(line)
        if shape == (1, 96 ** 3, 48):
            rows["K3"] = row
    return rows, k2_ms


def host_cost(dev, calls: int = 200, rounds: int = 5) -> None:
    """Host time of one wrapper call of K1, K2 (with and without its add)
    and K3 at [1, 27, 768] bf16, K4 (with its fold) at [1, 12^3, 128] ->
    128 with `[2, 128]` banks and K5 at [8, 27, 32] with 2 heads and no
    mask, all bf16: `calls` back-to-back calls after a
    synchronize, on the host clock up to the last call's return (the
    device work is a few us a call, so the host sets the pace), median of
    `rounds` rounds, the kernels taken in turns, in reverse order every
    other round; beside it the time to the end of the synchronize after
    them.  Twice: under inference mode, as served (the wrappers call the
    launchers directly), and under grad mode with x requiring a gradient
    (the wrappers run inside their autograd Functions, as in training).
    The host's speed swings between runs: compare kernels within a run,
    K1 being the same code in the trees compared so far."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn
    from miseg_tpu_torch.ops.kernels import window_attention as wa

    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    base = [torch.randn((1, 27, 768), generator=gen).to(dev, bf) for _ in range(2)]
    base_conv = torch.randn((1, 12, 12, 12, 128), generator=gen).to(dev, bf)
    w = (torch.randn((128, 128, 3, 3, 3), generator=gen) / 1728 ** 0.5).to(dev, bf)
    banks = [(m + 0.2 * torch.randn((2, 128), generator=gen)).to(dev, bf) for m in (1.0, 0.0)]
    styles = torch.tensor([1], dtype=torch.int32, device=dev)
    base_qkv = torch.randn((8, 27, 96), generator=gen).to(dev, bf)
    bias = torch.randn((2, 27, 27), generator=gen).to(dev)
    for grad in (False, True):
        x, r = (t.detach().requires_grad_(grad) for t in base)
        xc, qkv = (t.detach().requires_grad_(grad) for t in (base_conv, base_qkv))
        q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
        with torch.no_grad():
            sc, sh = fn.channel_scale_shift(x)
        calls_of = {
            "K1": lambda: fn.channel_scale_shift(x),
            "K2": lambda: fn.apply_scale_shift(x, sc, sh, negative_slope=0.01),
            "K2+add": lambda: fn.apply_scale_shift(x, sc, sh, r, negative_slope=0.01),
            "K3": lambda: fn.apply_norm2_act(x, sc, sh, r, sc, sh, negative_slope=0.01),
            "K4": lambda: fc.conv3_norm_columns(xc, w, gamma=banks[0], beta=banks[1],
                                                styles=styles),
            "K5": lambda: wa.window_attention(q, k, v, bias, None, num_heads=2),
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
        print(f"host ({mode}): us a wrapper call, bf16, K1-K3 at [1,27,768], K4 at "
              f"[1,12^3,128]->128, K5 at [8,27,32] h2 ({calls} calls after a "
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


# the volume shapes the flagship bundle exports as volume programs: the
# 224^3 request (64 windows) and the 160x192x128 one (48 windows)
SERVE_VOLUMES = [(224, 224, 224), (160, 192, 128)]
# kernel-name substrings of a profiled replay -> `PER_WINDOW` key, first
# match wins (the fold before the statistics kernel)
REPLAY_KERNELS = [("K1 fold", "miseg_k1_fold"), ("K1", "miseg_k1_stats"), ("K2", "miseg_k2_"),
                  ("K3", "miseg_k3_"), ("K4", "miseg_k4_"),
                  ("K5", ("miseg_k5_", "window_attention_kernel"))]


def replay_counts(events) -> dict:
    """Device kernels of profiled `events` by `PER_WINDOW` key, by name."""
    out = dict.fromkeys(PER_WINDOW, 0)
    for e in events:
        for key, subs in REPLAY_KERNELS:
            if any(sub in e.name for sub in ((subs,) if isinstance(subs, str) else subs)):
                out[key] += 1
                break
    return out


def gib(n: int) -> str:
    return f"{n / 2 ** 30:.3f} GiB"


def device_kernels(run, want: dict) -> dict:
    """Kernels by `PER_WINDOW` key that `run()` ran on the device, by name
    under the profiler (a CUDA graph replay launches nothing from Python,
    so only the profiler sees its kernels), after a lead call of `run`:
    the first of three sessions that counts `want`, else the last."""
    return replay_counts(profiled(run, lambda ev: replay_counts(ev) == want, lead=run))


def window_graph_kernels(served, vol, mod: int, per: dict, windows: int) -> dict:
    """What a request of `vol` served through the window graph runs on the
    device: the window graph must replay `windows` times in one
    `predict`, and one replayed window must run `per` kernels by name
    under the profiler (a whole UNetVanilla request's ~21,500 kernels
    read two short there in every session).  Returns `per` x the
    replays."""
    calls = served.window_graph.calls
    with torch.inference_mode():
        served.predict(vol, [mod])
    replays = served.window_graph.calls - calls
    check(replays == windows, f"a {tuple(vol.shape[1:-1])} request replayed the window graph "
                              f"{replays} times, want {windows}")
    window = torch.rand((1, *served.meta["roi"], int(served.meta["in_channels"])),
                        generator=torch.Generator().manual_seed(20)).to(served.device)
    mods = torch.tensor([mod], dtype=torch.int32, device=served.device)
    kernels = device_kernels(lambda: served(window, mods), per)
    check(kernels == per, f"a replayed window ran kernels by name {kernels}, want {per}")
    return {k: n * replays for k, n in kernels.items()}


def phase_serve(dev) -> tuple[dict, dict]:
    """The flagship bundle (seeded random weights, bf16, 96^3 ROI, gaussian
    blend, overlap 0.5), exported on the CPU with `SERVE_VOLUMES` as volume
    programs, once in each form (weights as arguments, and baked), served
    on the card.  In each form the four requests run three ways: eagerly
    (the generic inferer over the window program run as it is; the launch
    counters must rise by the per-window counts), through the served
    window (the generic inferer over `ServedModel.__call__`, one CUDA graph
    of a window replayed for each window: its first call warms up and
    captures, launching twice the per-window counts, then nothing from
    Python) and through the volume programs captured as CUDA graphs (the
    first request of a shape warms up and captures, launching twice the
    counts; a replay launches nothing from Python).  Each captured answer
    lies within the repeat tolerance of the eager one.  A profiled 224^3
    request through the window graph and one replay of each volume
    program must run `PER_WINDOW` x windows kernels by name, the 224^3
    ones giving the device busy time and idle share; memory with and
    without the graphs, and after the `ServedModel` is dropped.  Then the
    fused and unfused window, profiles of a served and of an uncaptured
    window, the start-up of a version-3 against a version-2 bundle, the
    exported window programs of the other three models against their
    live models, and SSLHead.  Returns (the Python launches of all the
    requests, the kernels of a 224^3 volume replay)."""
    import gc

    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import SlidingWindowInferer, window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import export_bundle, load_bundle

    cfg = Config(**FLAGSHIP)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    state = model_from_config(cfg, device="cpu").state_dict()
    export_s = {}
    for form, bake in (("arguments", False), ("baked", True)):
        t0 = time.perf_counter()
        export_bundle(cfg, state, root / form, volume_shapes=SERVE_VOLUMES, bake_params=bake)
        export_s[form] = time.perf_counter() - t0
    del state
    sizes = {f.name: f.stat().st_size for f in (root / "baked").iterdir()}
    print(f"serve: flagship bundles exported on the CPU (volume programs "
          f"{['x'.join(map(str, v)) for v in SERVE_VOLUMES]}): argument form "
          f"{export_s['arguments']:.1f} s, baked {export_s['baked']:.1f} s; file MB "
          + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in sorted(sizes.items())))
    gen = torch.Generator().manual_seed(2)
    vol_a = torch.rand((1, 224, 224, 224, 1), generator=gen)
    vol_b = torch.rand((1, 160, 192, 128, 1), generator=gen)
    requests = [("224^3 modality 0", vol_a, 0), ("224^3 modality 1", vol_a, 1),
                ("160x192x128 modality 0", vol_b, 0), ("224^3 modality 0 repeat", vol_a, 0)]
    windows = [len(window_starts(v.shape[1:-1], cfg.roi, cfg.infer_overlap)[1])
               for _, v, _ in requests]
    totals = dict.fromkeys(PER_WINDOW, 0)
    replay224 = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)

    def timed(fn, vol, mod):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn(vol, torch.tensor([mod], dtype=torch.int32))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        for k in PER_WINDOW:
            totals[k] += counts[k]
        return out, sec, counts

    for form in ("arguments", "baked"):
        served = load_bundle(root / form)
        check(served.compute_dtype == torch.bfloat16, "serve: bundle is not bf16")
        check(served.form == form, f"serve {form}: loaded the {served.form} window program")
        inferer = lambda fn: SlidingWindowInferer(   # noqa: E731
            fn, cfg.roi, cfg.sw_batch_size, cfg.infer_overlap, "gaussian",
            out_channels=cfg.out_channels, device=dev)
        eager, windowed = inferer(served.window_fn), inferer(served)
        torch.cuda.reset_peak_memory_stats(dev)
        outs, eager_s = [], []
        for (label, vol, mod), n in zip(requests, windows):
            out, sec, counts = timed(eager, vol, mod)
            eager_s.append(sec)
            check(tuple(out.shape) == (*vol.shape[:-1], cfg.out_channels),
                  f"serve {form} {label}: shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"serve {form} {label}: non-finite logits")
            want = {k: per * n for k, per in PER_WINDOW.items()}
            check(counts == want, f"serve {form} {label}: launched {counts}, want {want}")
            outs.append(out)
        peak_eager = torch.cuda.max_memory_allocated(dev)
        rep = max_err(outs[3], outs[0])
        rep_tol = 1e-3 * (1.0 + float(outs[0].abs().max()))
        check(rep <= rep_tol, f"serve {form}: repeated request differs by {rep:.3e} > "
                              f"{rep_tol:.3e}")

        def captured(i, label, out, first, what):
            want = {k: (2 * per if first else 0) for k, per in PER_WINDOW.items()}
            diff = max_err(out, outs[i])
            tol = 1e-3 * (1.0 + float(outs[i].abs().max()))
            check(diff <= tol, f"serve {form} {label} {what}: against eager {diff:.3e} > "
                               f"{tol:.3e}")
            return want, diff, tol

        graph_s = []
        for i, ((label, vol, mod), n) in enumerate(zip(requests, windows)):
            first = served.window_graph.graph is None
            out, sec, counts = timed(windowed, vol, mod)
            graph_s.append(sec)
            want, diff, tol = captured(i, label, out, first, "window graph")
            check(counts == want, f"serve {form} {label} window graph: launched {counts} "
                                  f"from Python, want {want}")
            check(out.data_ptr() != outs[i].data_ptr(), f"serve {form} {label}: aliasing")
            print(f"  request {form} {label}: {n} windows; eager {eager_s[i]:.3f} s, "
                  f"{n / eager_s[i]:.2f} windows/s; window graph {sec:.3f} s, "
                  f"{n / sec:.2f} windows/s" + (f" (capture {served.window_graph.capture_s:.3f}"
                                                 " s)" if first else "")
                  + f", against eager max |diff| {diff:.3e} (tol {tol:.3e})")
        peak_window = torch.cuda.max_memory_allocated(dev)
        seen = set()
        for i, ((label, vol, mod), n) in enumerate(zip(requests, windows)):
            spatial = tuple(vol.shape[1:-1])
            out, sec, counts = timed(served.predict, vol, mod)
            prog = served.volume_program(spatial)
            check(prog is not None and prog.graph is not None,
                  f"serve {form} {label}: no captured volume program")
            first = spatial not in seen
            seen.add(spatial)
            want, diff, tol = captured(i, label, out, first, "volume graph")
            want = {k: v * n for k, v in want.items()}
            check(counts == want, f"serve {form} {label}: launched {counts} from Python, "
                                  f"want {want} ({'warm-up and capture' if first else 'replay'})")
            check(out.data_ptr() != prog._out.data_ptr(),
                  f"serve {form} {label}: the answer is the graph's own buffer")
            what = (f"first call {sec:.3f} s (capture {prog.capture_s:.3f} s)" if first else
                    f"replay {sec:.3f} s, {n / sec:.2f} windows/s")
            print(f"  request {form} {label}: volume graph {what}; against eager max |diff| "
                  f"{diff:.3e} (tol {tol:.3e}); |logits| <= {float(outs[i].abs().max()):.3f}")
        for how, fn in (("window graph", lambda v: windowed(v, torch.tensor([0], dtype=torch.int32))),
                        ("volume replay", lambda v: served.predict(v, [0]))):
            for vol, n in ((vol_a, windows[0]), (vol_b, windows[2])):
                if how == "window graph" and vol is vol_b:
                    continue
                want = {k: per * n for k, per in PER_WINDOW.items()}
                walls = []

                def run(vol=vol, fn=fn):
                    t0 = time.perf_counter()
                    fn(vol)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)

                events = profiled(run, lambda ev, want=want: replay_counts(ev) == want)
                got = replay_counts(events)
                shape = "x".join(map(str, vol.shape[1:-1]))
                check(got == want, f"serve {form} {shape} {how}: kernels by name {got}, "
                                   f"want {want}")
                if vol is vol_a:
                    if how == "volume replay":
                        replay224 = got
                    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
                    _, groups = kernel_groups(events, 1)
                    print(f"  {how} {form} {shape} profiled: kernels by name {got} (= "
                          f"PER_WINDOW x {n}); {walls[-1]:.2f} ms wall under the profiler, "
                          f"{busy:.2f} ms device busy (idle share "
                          f"{max(0.0, 1 - busy / walls[-1]):.1%}), {len(events)} kernels; by "
                          "group ms: " + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(
                              groups.items(), key=lambda kv: -kv[1])))
                else:
                    print(f"  {how} {form} {shape} profiled: kernels by name {got} (= "
                          f"PER_WINDOW x {n})")
        peak_programs = torch.cuda.max_memory_allocated(dev)
        held = torch.cuda.memory_allocated(dev)
        if form == "arguments":
            compare_paths(served, cfg, dev)
            profile_window(served, dev, label="one 96^3 window served (window graph replay)")

            def uncaptured(window, mods):
                with torch.inference_mode():
                    return served.window_fn(window, mods)

            profile_window(uncaptured, dev, label="one 96^3 window, program run uncaptured")
        del served, eager, windowed, outs, out, prog
        gc.collect()
        torch.cuda.synchronize()
        if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):   # one per capture stream
            torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated(dev)
        print(f"  memory {form}: before load {gib(base)}; peak over the eager requests "
              f"{gib(peak_eager)}, with the window graph {gib(peak_window)}, with both volume "
              f"programs captured too {gib(peak_programs)}, held with all three {gib(held)}; "
              f"after the ServedModel is dropped {gib(after)}")
        check(after - base < 64 << 20, f"serve {form}: {gib(after - base)} left after the "
                                       f"ServedModel was dropped")
    serve_startup(root, dev)
    tmp.cleanup()
    print(f"serve: {len(requests)} full-width bf16 requests answered in each form, eagerly, "
          f"through the window graph and through captured volume programs; launches per "
          f"window {PER_WINDOW}")
    other_models_exported(dev)
    ssl_head_card_vs_cpu(dev)
    return totals, replay224


def serve_startup(root: Path, dev, rounds: int = 2) -> None:
    """`load_bundle` plus the first window's answer, for the version-3
    bundle (argument form) against a version-2 bundle of the same weights
    (its meta without programs: the model is rebuilt), in turns."""
    import gc
    import shutil

    from miseg_tpu_torch.serve import load_bundle

    v2 = root / "v2"
    v2.mkdir()
    meta = json.loads((root / "arguments" / "meta.json").read_text())
    old = {k: v for k, v in meta.items()
           if k not in ("platforms", "window_baked", "volume_programs")}
    (v2 / "meta.json").write_text(json.dumps({**old, "bundle_version": 2}))
    shutil.copy(root / "arguments" / "weights.pt", v2 / "weights.pt")
    window = torch.rand((1, 96, 96, 96, 1), generator=torch.Generator().manual_seed(6))
    took: dict[str, list[tuple[float, float]]] = {"version 3": [], "version 2": []}
    for _ in range(rounds):
        for name, path in (("version 3", root / "arguments"), ("version 2", v2)):
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served = load_bundle(path)
            t1 = time.perf_counter()
            served(window, [0])
            torch.cuda.synchronize()
            took[name].append((t1 - t0, time.perf_counter() - t0))
            del served
    print("  start-up (load_bundle / + the first 96^3 window's answer, s, "
          f"{rounds} rounds in turns): " + "; ".join(
              f"{k} " + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in v) for k, v in took.items()))


def other_models_exported(dev) -> None:
    """The exported window programs of C-UNETR, C-UNet and UNetVanilla
    (bf16 bundles exported on the CPU from seeded weights) on the card
    against their live models built on the card from the bundle's weights,
    one 96^3 window each: the program run as it is launches the per-window
    counts, the served window (a replay of its graph) runs the same
    kernels by name and launches nothing from Python, and both answers lie
    within the repeat tolerance of the live model's."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import _window_fn, export_bundle, load_bundle

    gen = torch.Generator().manual_seed(7)
    window = torch.rand((1, 96, 96, 96, 1), generator=gen).to(dev)
    for label, model_cfg, per in (("C-UNETR", UNETR, UNETR_PER_WINDOW),
                                  ("C-UNet", CUNET, CUNET_PER_WINDOW),
                                  ("UNetVanilla", VANILLA, VANILLA_PER_WINDOW)):
        cfg = Config(**model_cfg)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            export_bundle(cfg, model_from_config(cfg, device="cpu").state_dict(), tmp)
            export_s = time.perf_counter() - t0
            served = load_bundle(tmp)
        live = model_from_config(cfg, device=dev, dtype=torch.bfloat16)
        live.load_state_dict(served.state_dict(), strict=True)
        mods = torch.tensor([1], dtype=torch.int32, device=dev)
        served(window, mods)   # warm-up and capture
        torch.cuda.synchronize()
        reset_launches()
        with torch.inference_mode():
            got = served.window_fn(window, mods)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == per, f"exported {label} window: launched {counts}, want {per}")
        reset_launches()
        kernels = device_kernels(lambda: served(window, mods), per)
        check(kernels == per and launch_counts() == dict.fromkeys(PER_WINDOW, 0),
              f"exported {label} served window: kernels by name {kernels}, want {per}; "
              f"launched from Python {launch_counts()}")
        replayed = served(window, mods)
        with torch.inference_mode():
            want = _window_fn(live, torch.bfloat16)(window, mods)
        diff, diff_replay = max_err(got, want), max_err(replayed, want)
        tol = 1e-3 * (1.0 + float(want.abs().max()))
        check(bool(torch.isfinite(got).all()) and max(diff, diff_replay) <= tol,
              f"exported {label} window vs live model: {diff:.3e} / replayed "
              f"{diff_replay:.3e} > {tol:.3e}")
        print(f"  exported {label}: traced on the CPU in {export_s:.1f} s; one 96^3 bf16 window "
              f"on the card launches {counts}, its graph replays the same kernels; against "
              f"the live model max |diff| {diff:.3e}, replayed {diff_replay:.3e} "
              f"(tol {tol:.3e})")
        del served, live


def ssl_head_card_vs_cpu(dev, size: int = 96) -> None:
    """SSLHead ("vae" decoder, feature_size 48, dim 768), seeded weights:
    one `size`^3 forward in bf16 on the card (K5 launched 8 times, the
    decoder's 5 parameter-free norms one K1 and one K2 each) against the
    CPU in f32: each output finite, within 5% of its largest value, and
    with a cosine similarity of at least 0.999."""
    from miseg_tpu_torch.models import SSLHead
    from miseg_tpu_torch.models.factory import init_weights

    cpu = SSLHead(feature_size=48, upsample="vae", device="cpu").eval()
    init_weights(cpu, torch.Generator().manual_seed(16))
    card = SSLHead(feature_size=48, upsample="vae", device=dev, dtype=torch.bfloat16).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand((1, size, size, size, 1), generator=torch.Generator().manual_seed(17))
    with torch.inference_mode():
        card(x.to(dev, torch.bfloat16))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = card(x.to(dev, torch.bfloat16))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = launch_counts()
        t0 = time.perf_counter()
        want = cpu(x)
        cpu_s = time.perf_counter() - t0
    want_counts = {"K1": 5, "K2": 5, "K3": 0, "K4": 0, "K5": 8, "K1 fold": 0}
    check(counts == want_counts, f"ssl head: launched {counts}, want {want_counts}")
    words = []
    for name, g, w in zip(("rotation", "contrastive", "reconstruction"), got, want):
        g = g.float().cpu()
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"ssl head {name}: shape {tuple(g.shape)} or non-finite")
        err, scale = max_err(g, w), float(w.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        check(err <= 0.05 * scale and cos >= 0.999,
              f"ssl head {name}: card bf16 vs CPU f32 max |diff| {err:.3e} (|max| {scale:.3e}), "
              f"cosine {cos:.6f}")
        words.append(f"{name} {tuple(g.shape)} max |diff| {err:.3e} of {scale:.3e}, "
                     f"cosine {cos:.6f}")
    print(f"  ssl head (vae, fs48): one {size}^3 forward, card bf16 {card_s:.3f} s vs CPU f32 "
          f"{cpu_s:.1f} s; launches {counts}; " + "; ".join(words))


def compare_paths(served, cfg, dev, reps: int = 10) -> None:
    """One 96^3 bf16 window through a fused-conv-chain model and through an
    unfused model, both built on the card from the served bundle's
    weights: CUDA-event ms of each, timed in turns, and the max |diff| of
    their logits."""
    from miseg_tpu_torch.models import model_from_config

    fused = model_from_config(cfg, device=dev, dtype=torch.bfloat16)
    unfused = model_from_config(cfg, device=dev, dtype=torch.bfloat16, fused_conv=False)
    for model in (fused, unfused):
        model.load_state_dict(served.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(4)
    window = torch.rand((1, 96, 96, 96, 1), generator=gen).to(dev, torch.bfloat16)
    mods = torch.tensor([1], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        fused_out = fused(window, mods).float()
        plain_out = unfused(window, mods).float()
        models = {"fused": fused, "unfused": unfused}
        ms = {"fused": [], "unfused": []}
        for name in ("fused", "unfused", "unfused", "fused"):   # in turns
            ms[name].append(time_ms(lambda: models[name](window, mods), reps=reps))
    diff = max_err(fused_out, plain_out)
    check(bool(torch.isfinite(fused_out).all()), "paths: non-finite fused logits")
    print(f"paths: one 96^3 bf16 window, ms by CUDA events (median of {reps}, two "
          f"turns): fused conv chain {ms['fused'][0]:.3f} / {ms['fused'][1]:.3f}, "
          f"unfused (cuDNN + K1/K2) {ms['unfused'][0]:.3f} / {ms['unfused'][1]:.3f}; "
          f"logits max |diff| {diff:.3e} (|logits| <= {float(plain_out.abs().max()):.3f})")
    del fused, unfused


# kernel-name substrings -> group, first match wins
_GROUPS = [("K1", ("miseg_k1_",)), ("K2", ("miseg_k2_",)),
           ("K3", ("miseg_k3_",)), ("K4", ("miseg_k4_",)),
           ("K5", ("miseg_k5_", "window_attention_kernel")),
           ("conv (cuDNN)", ("conv", "xmma", "implicit", "cudnn", "fprop", "dgrad", "wgrad")),
           ("linear (GEMM)", ("gemm", "cutlass", "gemv", "nvjet")),
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


# K4's kernels, by the names a profile shows
K4_KERNELS = ("miseg_k4_conv_brick", "miseg_k4_conv_coarse", "miseg_k4_conv_cin1",
              "miseg_k4_conv_fma", "miseg_k4_splitk_reduce")


def window_faults(kernels, reps: int, per: dict = PER_WINDOW, k4: dict = WINDOW_K4
                  ) -> list[str]:
    """What is wrong with the device kernels of `reps` bf16 96^3 windows of
    a model that launches `per` (the launch counters' keys) a window, `k4`
    of its K4 launches taking the coarse and the Cin = 1 kernel: every bf16
    conv is one K4 kernel, every K1 call and every fold one CUDA K1 kernel,
    every K2, K3 and K5 call one CUDA kernel (the K2/K3 templates' `<...>`
    is in their names only), and no retired kernel (nor K4's FMA kernel or
    its split-K reduce, which no bf16 window of a supported model takes:
    the search space's widths are padded onto the tensor cores)."""
    if not kernels:
        return ["the profiler recorded no device events"]
    faults = []
    retired = sorted({e.name for e in kernels if any(k in e.name for k in (
        "miseg_k4_conv_wmma", "miseg_k1_stats_partial", "miseg_k1_stats_merge",
        "miseg_k1_stats_fold", "miseg_k4_splitk_reduce", "miseg_k4_conv_fma"))})
    if retired:
        faults.append(f"the bf16 window launched {retired}")
    k4_names = [e.name for e in kernels if "miseg_k4_" in e.name]
    coarse = sum("miseg_k4_conv_coarse" in n for n in k4_names)
    cin1 = sum("miseg_k4_conv_cin1" in n for n in k4_names)
    if not (len(k4_names) == per["K4"] * reps and coarse == k4["coarse"] * reps
            and cin1 == k4["cin1"] * reps):
        faults.append(f"{len(k4_names) / reps} K4 kernels a window, {coarse / reps} coarse, "
                      f"{cin1 / reps} Cin = 1; want {per['K4']}, {k4['coarse']} and "
                      f"{k4['cin1']}")
    k1 = [e.name for e in kernels if "miseg_k1_" in e.name]
    cuda_k1 = sum("miseg_k1_stats<" in n or "miseg_k1_fold" in n for n in k1)
    if not (len(k1) == (per["K1"] + per["K1 fold"]) * reps and cuda_k1 == len(k1)):
        faults.append(f"{len(k1) / reps} K1 kernels a window, {cuda_k1 / reps} of them the "
                      f"CUDA statistics and fold kernels; want {per['K1'] + per['K1 fold']}")
    for key, cuda_name in (("K2", "miseg_k2_apply<"), ("K3", "miseg_k3_apply2<")):
        names = [e.name for e in kernels if f"miseg_{key.lower()}_" in e.name]
        cuda = sum(cuda_name in n for n in names)
        if not (len(names) == per[key] * reps and cuda == len(names)):
            faults.append(f"{len(names) / reps} {key} kernels a window, {cuda / reps} of "
                          f"them the CUDA ones; want {per[key]}")
    k5 = [e.name for e in kernels if "miseg_k5_" in e.name or "window_attention" in e.name]
    if len(k5) != per["K5"] * reps or any("miseg_k5_attn_mma" not in n for n in k5):
        faults.append(f"{len(k5) / reps} K5 kernels a window; want {per['K5']}, all "
                      f"miseg_k5_attn_mma")
    return faults


def profile_window(served, dev, reps: int = 3, per: dict = PER_WINDOW,
                   k4: dict = WINDOW_K4, label: str = "one 96^3 window") -> None:
    """Where one 96^3 window's time goes: device time by kernel group over
    `reps` window forwards under torch.profiler, and the device idle share
    of the wall time.  Fails on any of `window_faults(..., per, k4)` in
    every session."""
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

    kernels = profiled(windows, lambda ev: not window_faults(ev, reps, per, k4),
                       lead=lambda: served(window, mods))
    faults = window_faults(kernels, reps, per, k4)
    check(not faults, f"profile ({len(walls)} sessions, window {event_ms:.2f} ms by CUDA "
                      f"events): " + "; ".join(faults) + "; the last session's first "
                      f"kernels: {[e.name[:60] for e in kernels[:8]]}")
    wall_ms = walls[-1]
    by_name, groups = kernel_groups(kernels, reps)
    busy = sum(groups.values())
    print(f"profile: {label}, bf16, {reps} reps: {event_ms:.2f} ms by CUDA events; "
          f"under the profiler {wall_ms:.2f} ms wall, {busy:.2f} ms device busy "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.1%}), {len(kernels) // reps} kernels; "
          f"profiler sessions {len(walls)}")
    print("  by group ms/window: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in top[:10] + [kv for kv in top[10:] if "miseg_k" in kv[0]]:
        print(f"  {ms:8.3f} ms  {name[:110]}")


def synthetic_scans(root: Path) -> list[dict]:
    """The two uploads of `phase_serve_http`, written with the port's
    `save_nifti` as `.nii.gz` from a fixed seed: a CT-like int16 scan
    (512x512x200 at 0.4x0.4x0.6 mm, LPS, -1000 HU air around concentric
    shells of +40..+400 HU) and an MR-like float32 scan (256x256x128 at
    1.2x1.2x1.5 mm, RAS, a sum of smooth gaussian blobs)."""
    import numpy as np

    from miseg_tpu_torch.data.nifti import save_nifti

    rng = np.random.default_rng(11)
    scans = []
    shape, spacing = (512, 512, 200), (0.4, 0.4, 0.6)
    center = (np.asarray(shape) - 1) / 2 + rng.uniform(-20, 20, size=3)
    ax = [((np.arange(n, dtype=np.float32) - c) * s) for n, c, s in zip(shape, center, spacing)]
    r = np.sqrt(ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2
                + ax[2][None, None, :] ** 2)
    ct = np.full(shape, -1000, np.int16)
    for radius, hu in zip(sorted(rng.uniform(10, 95, size=6), reverse=True),
                          (40, 100, 160, 240, 320, 400)):
        ct[r < radius] = hu
    affine = np.diag([-0.4, -0.4, 0.6, 1.0])
    affine[:3, 3] = [102.2, 110.6, -58.8]
    save_nifti(root / "ct_image.nii.gz", ct, affine)
    scans.append({"label": "CT 512x512x200 int16", "path": root / "ct_image.nii.gz",
                  "modality": 0})
    shape, spacing = (256, 256, 128), (1.2, 1.2, 1.5)
    ax = [np.arange(n, dtype=np.float32) * s for n, s in zip(shape, spacing)]
    mr = np.zeros(shape, np.float32)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, size=3) * np.asarray(shape) * np.asarray(spacing)
        w = rng.uniform(15, 60)
        g = [np.exp(-0.5 * ((a - ci) / w) ** 2) for a, ci in zip(ax, c)]
        mr += rng.uniform(100, 600) * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    affine = np.diag([1.2, 1.2, 1.5, 1.0])
    affine[:3, 3] = [-150.0, -140.0, -90.0]
    save_nifti(root / "mr_image.nii.gz", mr, affine)
    scans.append({"label": "MR 256x256x128 float32", "path": root / "mr_image.nii.gz",
                  "modality": 1})
    return scans


def http(url: str, body: bytes | None = None) -> tuple[int, dict, bytes]:
    """(status, headers, body) of a GET (no body) or POST to `url`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def host_costs(service, scan) -> None:
    """What two of the request's host costs would be otherwise, on the same
    scan (the service itself is unchanged): the chain with the image alone
    against the service's image + "label" copy, and the answer's gzip at
    levels 1 and 6 against the service's level 9 (its requests' encode)."""
    import gzip

    import numpy as np

    from miseg_tpu_torch.data.nifti import save_nifti

    path = str(scan["path"])
    t0 = time.perf_counter()
    service.chain({"image": path})
    alone = time.perf_counter() - t0
    t0 = time.perf_counter()
    service.chain({"image": path, "label": path})
    both = time.perf_counter() - t0
    raw = scan["path"].with_suffix("").with_suffix(".answer.nii")
    save_nifti(raw, scan["want"].astype(np.uint16), scan["native"].affine)
    payload = raw.read_bytes()
    took = {}
    for level in (1, 6):
        t0 = time.perf_counter()
        size = len(gzip.compress(payload, compresslevel=level))
        took[level] = (time.perf_counter() - t0, size)
    print(f"  host {scan['label']}: chain image alone {alone:.3f} s, image + label "
          f"{both:.3f} s; answer {len(payload) / 1e6:.1f} MB raw, gzip level 1 "
          f"{took[1][0]:.3f} s ({took[1][1] / 1e6:.2f} MB), level 6 {took[6][0]:.3f} s "
          f"({took[6][1] / 1e6:.2f} MB); the service writes level 9")


def phase_serve_http(dev, card: str) -> dict:
    """The serving-from-disk path over a real socket: the flagship bundle
    (seeded random weights, bf16) behind `cli.serve.make_server`, two
    synthetic scans POSTed as `.nii.gz`.  Checks the routes, that each
    answer is a uint16 NIfTI in the scan's own grid with exactly its
    affine, voxel for voxel the in-process pipeline's labels, each request
    through its CUDA graphs (the CT's volume program once, the window
    graph once a window for the MR, nothing launched from Python), no
    autograd Function run and logits that need no gradient in the handler
    thread, and the same answers when both scans arrive at once.  Returns
    the kernels by name of one served MR predict (`PER_WINDOW` x its
    windows)."""
    import threading

    import numpy as np

    from miseg_tpu_torch.cli.predict_whs import MMWHS_LABEL_MAP, remap_labels
    from miseg_tpu_torch.cli.serve import _eval_chain, make_server
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.data.nifti import load_nifti
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import export_bundle

    t_phase = time.perf_counter()
    cfg = Config(**FLAGSHIP)
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    scans = http_scans(root)
    write_s = time.perf_counter() - t0
    # the CT's preprocessed shape gets a volume program
    chain = _eval_chain({"spacing": list(cfg.spacing), "roi": list(cfg.roi)})
    ct_shape = tuple(chain({"image": str(scans[0]["path"])})["image"].shape[:3])
    ct_tag = "x".join(map(str, ct_shape))
    t0 = time.perf_counter()
    export_bundle(cfg, model_from_config(cfg, device="cpu").state_dict(), root / "bundle",
                  volume_shapes=[ct_shape])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = make_server(str(root / "bundle"), port=0)
    make_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service = server.RequestHandlerClass.service
    base = f"http://127.0.0.1:{server.server_port}"

    # what the handler threads do on the device: where predict runs, under
    # inference mode or not, whether its logits need a gradient, and every
    # autograd Function applied while requests run
    seen, applied = [], []
    predict = service.served.predict
    function_apply = torch.autograd.Function.__dict__["apply"]

    def watched_predict(*args, **kwargs):
        out = predict(*args, **kwargs)
        seen.append((threading.current_thread() is not threading.main_thread(),
                     torch.is_inference_mode_enabled(), out.requires_grad))
        return out

    def counting_apply(cls, *args, **kwargs):
        applied.append(cls.__name__)
        return function_apply.__func__(cls, *args, **kwargs)

    service.served.predict = watched_predict
    torch.autograd.Function.apply = classmethod(counting_apply)
    try:
        # ---- routes -------------------------------------------------------
        status, _, body = http(f"{base}/health")
        health = json.loads(body)
        check(status == 200 and health.get("roi") == list(cfg.roi)
              and health.get("spacing") == list(cfg.spacing),
              f"http: GET /health {status} {str(health)[:200]}")
        status, _, body = http(f"{base}/nope")
        check(status == 404, f"http: GET /nope answered {status}")
        status, _, body = http(f"{base}/predict?modality=0", b"")
        check(status == 400 and "error" in json.loads(body),
              f"http: an empty POST answered {status} {body[:200]!r}")

        # ---- the in-process pipeline on the same bytes ---------------------
        for scan in scans:
            scan["bytes"] = scan["path"].read_bytes()
            scan["native"] = load_nifti(scan["path"])
            sample = service.preprocess(scan["bytes"])
            image = torch.from_numpy(np.ascontiguousarray(sample["image"]))[None]
            with torch.inference_mode():
                logits = predict(image, [scan["modality"]])
                again = predict(image, [scan["modality"]])
                scan["repeatable"] = bool(torch.equal(logits, again))
                pred = logits[0].argmax(dim=-1).to(torch.int32).cpu().numpy()
                del logits, again
            inv = dict(sample)
            inv["label"] = pred[..., None].astype(np.float32)
            inverted = service.chain.inverse(inv, key="label")["label"]
            scan["want"] = np.rint(np.asarray(inverted)).astype(np.int32)
            scan["windows"] = len(window_starts(sample["image"].shape[:3], cfg.roi,
                                                cfg.infer_overlap)[1])
            host_costs(service, scan)
        check([s["windows"] for s in scans] == [32, 108],
              f"http: windows {[s['windows'] for s in scans]}, want 32 and 108")

        def answer(scan, out: bytes, remap: bool) -> np.ndarray:
            path = root / f"answer-{threading.get_ident()}.nii.gz"
            path.write_bytes(out)
            got = load_nifti(path)
            label = scan["label"] + (" remap=whs" if remap else "")
            check(got.data.shape == scan["native"].data.shape,
                  f"http {label}: shape {got.data.shape}, want {scan['native'].data.shape}")
            check(np.array_equal(got.affine, scan["native"].affine),
                  f"http {label}: affine\n{got.affine}\nwant\n{scan['native'].affine}")
            check(got.data.dtype == np.uint16, f"http {label}: dtype {got.data.dtype}")
            allowed = ({0, *MMWHS_LABEL_MAP.values()} if remap else set(range(cfg.out_channels)))
            values = set(np.unique(got.data).tolist())
            check(values <= allowed, f"http {label}: values {sorted(values)}")
            want = remap_labels(scan["want"]) if remap else scan["want"]
            wrong = int(np.count_nonzero(got.data != want))
            # bitwise unless the window itself is not repeatable (PERF.md)
            check(wrong == 0 or (not scan["repeatable"] and wrong < 1e-6 * want.size),
                  f"http {label}: {wrong} of {want.size} voxels differ from the in-process "
                  f"pipeline (logits repeatable: {scan['repeatable']})")
            return got.data

        # the CT's volume program was captured by the pipeline above, the
        # window graph by make_server's warm-up window; the CT's requests
        # replay the program and the MR's the window graph for each of its
        # windows, launching nothing from Python.  What an MR request runs
        # on the device is counted by name under the profiler.
        served = service.served
        program = served.volume_program(ct_shape)
        check(program is not None and program.graph is not None
              and served.loaded_volume_programs() == [ct_tag],
              f"http: the CT's volume program {ct_tag} was not captured")
        check(program.calls == 2,
              f"http: {program.calls} calls of the CT's volume program, want 2")
        check(served.window_graph.graph is not None,
              "http: the served window was not captured")
        mr_image = torch.from_numpy(np.ascontiguousarray(
            service.preprocess(scans[1]["bytes"])["image"]))[None]
        http_kernels = window_graph_kernels(served, mr_image, 1, PER_WINDOW,
                                            scans[1]["windows"])
        del mr_image
        def stages(headers, windows: int) -> str:
            ms = {k: float(v) for k, v in (part.split(";dur=") for part in
                                           headers["Server-Timing"].split(", "))}
            return (f"s: upload+decode {ms['upload'] / 1e3:.3f}, preprocess "
                    f"{ms['preprocess'] / 1e3:.3f}, device predict {ms['predict'] / 1e3:.3f} "
                    f"({windows / (ms['predict'] / 1e3):.2f} windows/s), argmax+copy "
                    f"{ms['argmax'] / 1e3:.3f}, inverse {ms['inverse'] / 1e3:.3f}, encode "
                    f"{ms['encode'] / 1e3:.3f}, total {ms['total'] / 1e3:.3f} (lock wait "
                    f"{ms['wait'] / 1e3:.3f})")

        # ---- both scans at once, the CT's with remap=whs (each answer gzips
        # ~25 s on the host; a serial CT request before them took as long) ----
        torch.cuda.synchronize()
        reset_launches()
        seen.clear()
        applied.clear()
        calls, window_calls = program.calls, served.window_graph.calls
        results: dict[str, tuple] = {}
        barrier = threading.Barrier(len(scans))

        def post(scan):
            barrier.wait(timeout=60)
            remap = "&remap=whs" if scan is scans[0] else ""
            results[scan["label"]] = http(
                f"{base}/predict?modality={scan['modality']}{remap}", scan["bytes"])

        clients = [threading.Thread(target=post, args=(s,)) for s in scans]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        both_s = time.perf_counter() - t0
        check(not any(c.is_alive() for c in clients), "http: a concurrent request hung")
        counts = launch_counts()
        check(counts == dict.fromkeys(PER_WINDOW, 0),
              f"http concurrent: launched {counts} from Python, want none (graph replays)")
        ran = (program.calls - calls, served.window_graph.calls - window_calls)
        check(ran == (1, scans[1]["windows"]),
              f"http concurrent: the CT's program and the window graph ran {ran} times, "
              f"want (1, {scans[1]['windows']})")
        check(len(seen) == 2 and all(s == (True, True, False) for s in seen) and not applied,
              f"http concurrent: handler predicts {seen}, Functions {sorted(set(applied))}")
        for scan in scans:
            status, headers, out = results[scan["label"]]
            remap = scan is scans[0]
            check(status == 200, f"http concurrent {scan['label']}: status {status}")
            answer(scan, out, remap)   # against the in-process pipeline
            print(f"  http concurrent {scan['label']}{' remap=whs' if remap else ''}: "
                  f"{scan['windows']} windows; {stages(headers, scan['windows'])}")
    finally:
        torch.autograd.Function.apply = function_apply
        service.served.predict = predict
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        tmp.cleanup()
    print(card)
    print(f"serve_http: {len(scans)} scans over HTTP at once "
          f"(the CT's with remap=whs), "
          f"answers in each scan's grid with its exact affine, equal to the in-process "
          f"pipeline (logits repeatable: {[s['repeatable'] for s in scans]}); the CT's "
          f"requests ({ct_tag}) through its captured volume program, the MR's through the "
          f"window graph (PER_WINDOW x windows kernels by name); no autograd Function in "
          f"the handlers; scans written in "
          f"{write_s:.1f} s, bundle exported on the CPU in {export_s:.1f} s, make_server "
          f"{make_s:.1f} s, both at once {both_s:.3f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return http_kernels


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


def train_card_vs_cpu(dev, size: int = 64, model: dict = FLAGSHIP, dims: int = 3,
                      batch_size: int = 1) -> None:
    """(b) One f32 AdamW step of `model` (the fs-48 flagship unless given)
    at a `size`^`dims` ROI, batch `batch_size`, on the card against the
    same step in the port on the CPU: loss within 1e-5, every gradient
    leaf within 5e-5 and their sum within 1e-3, the parameters after the
    step within rtol 1e-4 / atol 2.5e-4 (the bounds the CPU tests hold the
    port to against JAX)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    cfg = Config(**{**model, "roi_x": size, "roi_y": size, "roi_z": size, "no_amp": True})
    shape = (batch_size, *(size,) * dims)
    gen = torch.Generator().manual_seed(7)
    batch = {"image": torch.randn((*shape, 1), generator=gen),
             "label": torch.randint(0, cfg.out_channels, shape, generator=gen),
             "modality": torch.tensor([1, 0][:batch_size], dtype=torch.int32)}
    cpu = Trainer(cfg, device="cpu")
    card = Trainer(cfg, device=dev)
    states = {"cpu": cpu.init_state(), "card": card.init_state(cpu.model.state_dict())}
    losses, took = {}, {}
    for name, trainer in (("cpu", cpu), ("card", card)):
        t0 = time.perf_counter()
        states[name], loss = trainer.train_step(states[name], batch)
        losses[name] = float(loss)
        took[name] = time.perf_counter() - t0
    where = f"train step {size}^{dims}"
    loss_err = abs(losses["card"] - losses["cpu"])
    check(loss_err <= 1e-5, f"{where}: card vs CPU loss {loss_err:.3e} > 1e-5")
    gaps, worst_p = {}, 0.0
    for n, p in states["cpu"].params.items():
        q = states["card"].params[n]
        check(q.grad is not None, f"{where}: {n} has no gradient on the card")
        gaps[n] = max_err(q.grad.cpu(), p.grad)
        d = (q.detach().cpu() - p.detach()).abs() - (2.5e-4 + 1e-4 * p.detach().abs())
        worst_p = max(worst_p, float(d.max()))
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= 5e-5 and sum(gaps.values()) <= 1e-3,
          f"{where}: gradient gap worst {worst} {gaps[worst]:.3e} (tol 5e-5), "
          f"summed {sum(gaps.values()):.3e} (tol 1e-3)")
    check(worst_p <= 0.0, f"{where}: parameters after the step exceed "
                          f"rtol 1e-4 / atol 2.5e-4 by {worst_p:.3e}")
    print(f"  train step {cfg.model_name} fs{cfg.feature_size_scalar} {size}^{dims} batch "
          f"{batch_size} f32 (TF32 off), card vs CPU: loss {losses['card']:.6f} "
          f"|diff| {loss_err:.2e} (tol 1e-05); gradient gap over {len(gaps)} leaves summed "
          f"{sum(gaps.values()):.3e} (tol 1e-03), worst {worst} {gaps[worst]:.2e} (tol 5e-05); "
          f"parameters after one AdamW step within rtol 1e-4 / atol 2.5e-4; "
          f"step {took['card']:.2f} s card (first call), {took['cpu']:.1f} s CPU")


def synthetic_case(size: int, classes: int, gen, dims: int = 3):
    """A seeded image and label of `size`^`dims`: concentric shells around
    the centre, one class a shell, and an image that is the label plus
    noise."""
    ax = torch.arange(size, dtype=torch.float32) - (size - 1) / 2
    grids = torch.meshgrid(*(ax,) * dims, indexing="ij")
    r = torch.sqrt(sum(g ** 2 for g in grids))
    label = (r / (size / (2 * classes))).long().clamp(max=classes - 1)[None]
    image = label.float()[..., None] / classes + 0.1 * torch.randn((1, *(size,) * dims, 1),
                                                                   generator=gen)
    return image, label


def train_full(dev, card: str, warmup: int = 2, steps: int = 10, model: dict = FLAGSHIP,
               per: dict = PER_WINDOW, k4: dict = WINDOW_K4) -> dict:
    """(c) The training step of `model` (the flagship unless given) at full
    width: its 96^3 (or, 2-D, 96^2) ROI, batch 1, bf16 compute with f32
    masters, AdamW, `dice_focal`, on one fixed seeded batch; one step's
    forward must launch `per`, its profile pass `window_faults(..., per,
    k4)`.  Returns the launches of each kernel in one step."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    cfg = Config(**model)
    gen = torch.Generator().manual_seed(8)
    image, label = synthetic_case(96, cfg.out_channels, gen, len(cfg.roi))
    batch = {"image": image.to(dev), "label": label.to(dev),
             "modality": torch.tensor([0], dtype=torch.int32, device=dev)}
    trainer = Trainer(cfg, device=dev)
    check(trainer.compute_dtype == torch.bfloat16, f"train {cfg.model_name}: not bf16")
    state = trainer.init_state()
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        if i == 0:
            reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = trainer.train_step(state, batch)
        end.record()
        if i == 0:
            counts = launch_counts()
        end.synchronize()
        losses.append(float(loss))
        if i >= warmup:
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    check(counts == per, f"train {cfg.model_name}: one step launched {counts}, want {per}")
    check(all(math.isfinite(v) for v in losses), f"train {cfg.model_name}: losses {losses}")
    check(losses[-1] < losses[0], f"train {cfg.model_name}: loss did not fall: "
                                  f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    bad = [n for n, p in state.params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
    check(not bad, f"train {cfg.model_name}: {len(bad)} parameters with a missing, non-finite or zero "
                   f"gradient, e.g. {bad[:3]}")

    walls = []

    def one_step():
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    kernels = profiled(one_step, lambda ev: not window_faults(ev, 1, per, k4),
                       lead=lambda: trainer.train_step(state, batch))
    faults = window_faults(kernels, 1, per, k4)
    check(not faults, f"train {cfg.model_name} profile: " + "; ".join(faults)
          + f"; the last session's first kernels: {[e.name[:60] for e in kernels[:8]]}")
    by_name, groups = kernel_groups(kernels, 1)
    busy = sum(groups.values())
    print(f"  train step {cfg.model_name} fs{cfg.feature_size_scalar} 96^{len(cfg.roi)} bf16 "
          f"(f32 masters), "
          f"batch 1, AdamW, dice_focal on '{card}': "
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


def fit_keys(prefix: str, classes: int, surface: bool) -> set[str]:
    """The metric names `Trainer.evaluate` gives a CT + MR set (the JAX
    package's names)."""
    keys = {f"{prefix}/loss/avg", f"{prefix}/accuracy/avg", f"{prefix}_total_dice/avg"}
    kinds = ["dice"] + (["surface_distance"] if surface else [])
    for c in range(classes):
        keys |= {f"{prefix}/accuracy/class_{c}", f"{prefix}_total_dice/class{c}"}
    for m in (0, 1):
        keys |= {f"{prefix}/accuracy/modality_{m}", f"{prefix}/loss/modality_{m}"}
        for kind in kinds:
            keys |= {f"{prefix}_modality{m}_{kind}/class{c}" for c in range(classes)}
            keys.add(f"{prefix}_modality{m}_{kind}/avg")
    if surface:
        keys |= {f"{prefix}_total_surface_distance/class{c}" for c in range(classes)}
        keys.add(f"{prefix}_total_surface_distance/avg")
    return keys


def check_metrics(label: str, metrics: dict, prefix: str, classes: int, surface: bool) -> None:
    """The expected names; losses and Dice finite (Dice in [0, 1]); surface
    distances finite or +inf (a class the net does not predict yet).  The
    synthetic volumes hold every class, so no Dice is NaN."""
    want = fit_keys(prefix, classes, surface)
    check(set(metrics) == want, f"{label}: metric names differ: missing "
                                f"{sorted(want - set(metrics))[:4]}, extra "
                                f"{sorted(set(metrics) - want)[:4]}")
    for k, v in metrics.items():
        if "surface" in k:
            check(not math.isnan(v) and v >= 0, f"{label}: {k} = {v}")
        else:
            check(math.isfinite(v), f"{label}: {k} = {v}")
            if "loss" not in k:
                check(0.0 <= v <= 1.0, f"{label}: {k} = {v}")


def same_metrics(a: dict, b: dict) -> bool:
    """Equal names, values within 1e-6 relative (or both infinite)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or abs(a[k] - b[k]) <= 1e-6 * (1.0 + abs(b[k])) for k in a)


def fit_card_vs_cpu(dev, root: Path, size: int = 64) -> None:
    """`evaluate` of the fs-48 model at a `size`^3 ROI in f32 on the card
    against the CPU, same weights, on one `size`^3 volume a modality:
    labels equal on >= 99.99% of the voxels, every Dice within 1e-3 and
    the loss within 1e-4."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.data.multi_modal import MultiModalData
    from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
    from miseg_tpu_torch.inferers import SlidingWindowInferer
    from miseg_tpu_torch.train.engine import Trainer
    from miseg_tpu_torch.utils.logging import MetricLogger

    make_synthetic_dataset(root, shape=(size,) * 3, num_classes=6, n_train=0, n_val=1,
                           n_test=0, spacing=(1.0, 1.0, 1.0), seed=12, suffix=".nii")
    cfg = Config(**{**FLAGSHIP, "roi_x": size, "roi_y": size, "roi_z": size, "no_amp": True,
                    "data_dirs": [str(root)] * 2, "json_lists": ["CT.json", "MR.json"],
                    "num_workers": 2})
    trainers = {name: Trainer(cfg, device=d, workdir=str(root / name),
                              logger=MetricLogger(root / name, quiet=True))
                for name, d in (("cpu", "cpu"), ("card", dev))}
    states = {"cpu": trainers["cpu"].init_state()}
    states["card"] = trainers["card"].init_state(trainers["cpu"].model.state_dict())
    metrics, labels, took = {}, {"cpu": [], "card": []}, {}
    infer = SlidingWindowInferer.__call__
    try:
        for name, trainer in trainers.items():
            def recording(self, *args, _sink=labels[name]):
                out = infer(self, *args)
                _sink.append(out.argmax(-1).cpu())
                return out

            SlidingWindowInferer.__call__ = recording
            t0 = time.perf_counter()
            metrics[name] = trainer.evaluate(MultiModalData(cfg).val_dataloader(),
                                             states[name])
            took[name] = time.perf_counter() - t0
    finally:
        SlidingWindowInferer.__call__ = infer
    check(len(labels["cpu"]) == len(labels["card"]) == 2,
          f"fit: card vs CPU evaluate ran {len(labels['cpu'])}, {len(labels['card'])} volumes")
    same = sum(int((a == b).sum()) for a, b in zip(labels["card"], labels["cpu"]))
    total = sum(a.numel() for a in labels["cpu"])
    dice_gap = max(abs(metrics["card"][k] - metrics["cpu"][k]) for k in metrics["cpu"]
                   if ("dice" in k or "accuracy" in k) and math.isfinite(metrics["cpu"][k]))
    loss_gap = max(abs(metrics["card"][k] - metrics["cpu"][k]) for k in metrics["cpu"]
                   if "loss" in k)
    check(same >= 0.9999 * total, f"fit: card vs CPU evaluate labels agree on {same} of "
                                  f"{total} voxels (< 99.99%)")
    check(dice_gap <= 1e-3 and loss_gap <= 1e-4,
          f"fit: card vs CPU evaluate Dice |diff| {dice_gap:.3e} (tol 1e-3), loss "
          f"{loss_gap:.3e} (tol 1e-4)")
    print(f"  evaluate fs48 {size}^3 f32 (TF32 off), card vs CPU, 2 volumes: labels equal on "
          f"{same / total:.6%} of {total} voxels (want >= 99.99%), Dice |diff| {dice_gap:.2e} "
          f"(tol 1e-3), loss |diff| {loss_gap:.2e} (tol 1e-4); {took['card']:.2f} s card, "
          f"{took['cpu']:.1f} s CPU")


def pct(values, q: float) -> float:
    return float(torch.quantile(torch.tensor(values, dtype=torch.float64), q))


@contextlib.contextmanager
def counting_fit():
    """While the block runs: the launch counts of every `Trainer.train_step`
    (`rec["steps"]`), of every `Trainer.evaluate` with its prefix, windows,
    seconds and seconds of surface distance (`rec["evals"]`), and the
    autograd Functions applied inside an evaluate (`rec["applied"]`), by
    wrapping the two methods at class level and
    `torch.autograd.Function.apply`; all three are restored after."""
    from miseg_tpu_torch.train import engine

    rec = {"steps": [], "evals": [], "applied": []}
    in_eval = []
    train_step, evaluate = engine.Trainer.train_step, engine.Trainer.evaluate
    function_apply = torch.autograd.Function.__dict__["apply"]

    def counted_step(self, state, batch):
        reset_launches()
        out = train_step(self, state, batch)
        rec["steps"].append(launch_counts())
        return out

    def counted_evaluate(self, loader, state, **kw):
        reset_launches()
        n_windows, n_surface = len(self.history["eval_windows"]), len(self.history["surface_s"])
        in_eval.append(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            metrics = evaluate(self, loader, state, **kw)
        finally:
            in_eval.pop()
        torch.cuda.synchronize()
        rec["evals"].append(dict(prefix=kw.get("prefix", "val"), counts=launch_counts(),
                                 windows=sum(self.history["eval_windows"][n_windows:]),
                                 s=time.perf_counter() - t0,
                                 surface_s=sum(self.history["surface_s"][n_surface:])))
        return metrics

    def counting_apply(cls, *args, **kwargs):
        if in_eval:
            rec["applied"].append(cls.__name__)
        return function_apply.__func__(cls, *args, **kwargs)

    engine.Trainer.train_step, engine.Trainer.evaluate = counted_step, counted_evaluate
    torch.autograd.Function.apply = classmethod(counting_apply)
    try:
        yield rec
    finally:
        engine.Trainer.train_step, engine.Trainer.evaluate = train_step, evaluate
        torch.autograd.Function.apply = function_apply


def check_fit_launches(label: str, rec: dict, per: dict, per_step: dict | None = None) -> None:
    """Every train step of `rec` (`counting_fit`) launched `per_step`
    (default `per`), every evaluate `per` x its windows, and no autograd
    Function ran in one."""
    per_step = per_step or per
    bad = [c for c in rec["steps"] if c != per_step]
    check(not bad, f"{label}: {len(bad)} train steps launched other counts than {per_step}, "
                   f"e.g. {bad[:1]}")
    for ev in rec["evals"]:
        want = {k: n * ev["windows"] for k, n in per.items()}
        check(ev["windows"] > 0 and ev["counts"] == want,
              f"{label}: a {ev['prefix']} evaluate of {ev['windows']} windows launched "
              f"{ev['counts']}, want {want}")
    check(not rec["applied"], f"{label}: {len(rec['applied'])} autograd Functions ran in "
                              f"evaluate, e.g. {rec['applied'][:3]}")


def phase_fit(dev, card: str, shape=(192, 192, 160), small: int = 64) -> dict:
    """A training run through the normal entry points on the card:
    `cli.train.main` fits the flagship (full width, bf16, batch 1, one 96^3
    crop a volume) for 3 epochs on a synthetic CT + MR set (192 x 192 x 160
    at 1.0 mm, 6 classes, 2 train / 1 val / 1 test volumes a modality),
    validating every epoch, with warmup_cosine and 2 loader threads, and
    tests best.ckpt; a 4th epoch resumed from last.ckpt; `cli.test.main` on
    best.ckpt.  Every train step must launch one window's kernels and every
    validation `PER_WINDOW` x its windows, with no autograd Function in
    `evaluate`.  Returns the launches in train steps and in validations."""
    from miseg_tpu_torch.cli import test as cli_test
    from miseg_tpu_torch.cli import train as cli_train
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train import schedules
    from miseg_tpu_torch.train.checkpoint import load_checkpoint
    from miseg_tpu_torch.train.optim import current_learning_rate

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = fit_data(tmp, shape, 6)
        data_s = time.perf_counter() - t0
        cfg = Config(**{**FLAGSHIP, "data_dirs": [str(root)] * 2,
                        "json_lists": ["CT.json", "MR.json"], "max_epochs": 3,
                        "check_val_every_n_epoch": 1, "scheduler": "warmup_cosine",
                        "warmup_epochs": 1, "batch_size": 1, "patches_training_sample": 1,
                        "num_workers": 2, "cache_num": 8, "log_every_n_steps": 1,
                        "default_root_dir": str(Path(tmp) / "runs"),
                        "experiment_name": "flagship"})
        with counting_fit() as rec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer, state, test_metrics = cli_train.main(cfg, device=dev)
            fit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            workdir = Path(cfg.default_root_dir) / "flagship"
            fit_steps, fit_evals = len(rec["steps"]), len(rec["evals"])
            resume_cfg = cfg.replace(max_epochs=4, ckpt_path=str(workdir / "last.ckpt"),
                                     experiment_name="flagship_resumed")
            t0 = time.perf_counter()
            resumed, r_state, _ = cli_train.main(resume_cfg, device=dev)
            resume_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli_metrics = cli_test.main(cfg.replace(ckpt_path=str(workdir / "best.ckpt")),
                                        device=dev)
            test_s = time.perf_counter() - t0
        step_counts, evals = rec["steps"], rec["evals"]

        # ---- launches and autograd -------------------------------------
        check(fit_steps == 12 and len(step_counts) == 16,
              f"fit: {fit_steps} train steps in 3 epochs, {len(step_counts)} with the resumed "
              f"epoch (want 12, 16)")
        check_fit_launches("fit", rec, PER_WINDOW)
        # ---- metrics, checkpoints, resume --------------------------------
        lines = [json.loads(ln) for ln in open(workdir / "metrics.jsonl")]
        vals = [ln for ln in lines if "val/loss/avg" in ln]
        check(len(vals) == 3, f"fit: {len(vals)} validations in 3 epochs")
        for ln in vals:
            check_metrics(f"fit val epoch {ln['step']}",
                          {k: v for k, v in ln.items() if k not in ("ts", "step")},
                          "val", cfg.out_channels, False)
        check_metrics("fit test", test_metrics, "test", cfg.out_channels, True)
        check_metrics("cli.test", cli_metrics, "test", cfg.out_channels, True)
        check(same_metrics(cli_metrics, test_metrics),
              "fit: cli.test on best.ckpt differs from the run's own test of best.ckpt")
        names = sorted(p.name for p in (workdir / "checkpoints").iterdir())
        check(len([n for n in names if n.startswith("epoch") and n.endswith(".ckpt")]) == 3
              and "last.ckpt" in names and "manager.json" in names,
              f"fit: checkpoints/ holds {names}")
        for path in (workdir / "best.ckpt", workdir / "last.ckpt"):
            ck = load_checkpoint(path)
            check(len(ck["params"]) == 203 and all(bool(torch.isfinite(v).all())
                                                   for v in ck["params"].values()),
                  f"fit: {path.name} does not reload 203 finite parameters")
        last = load_checkpoint(workdir / "last.ckpt")
        check(last["epoch"] == 2 and last["opt_state"]["gradient_step"] == 12,
              f"fit: last.ckpt at epoch {last['epoch']}, step "
              f"{last['opt_state']['gradient_step']} (want 2, 12)")
        r_lines = [json.loads(ln) for ln in
                   open(Path(cfg.default_root_dir) / "flagship_resumed" / "metrics.jsonl")]
        r_steps = [ln["step"] for ln in r_lines if "Charts/lr_step" in ln]
        r_epochs = [ln["step"] for ln in r_lines if "train/loss" in ln]
        want_lr = schedules.warmup_cosine(3, lr=cfg.lr, warmup_epochs=1, t_total=4)
        r_lr = [ln["Charts/lr_step"] for ln in r_lines if "Charts/lr_step" in ln]
        check(r_steps == [12, 13, 14, 15] and r_epochs == [3] and r_state.step == 16,
              f"fit: resume ran steps {r_steps}, epochs {r_epochs}, ended at step "
              f"{r_state.step} (want 12..15, [3], 16)")
        check(all(abs(v - want_lr) <= 1e-12 for v in r_lr)
              and abs(current_learning_rate(r_state.optimizer) - want_lr) <= 1e-12,
              f"fit: resumed lr {r_lr}, want {want_lr}")
        check(len(resumed.history["step_ms"]) == 4, "fit: the resumed epoch timed "
                                                    f"{len(resumed.history['step_ms'])} steps")
        # ---- card vs CPU -------------------------------------------------
        fit_card_vs_cpu(dev, Path(tmp) / "small", small)

    h = trainer.history
    ms = h["step_ms"][1:]                        # the first step warms up
    waits = h["loader_wait_s"]
    val_evals = [e for e in evals[:fit_evals] if e["prefix"] == "val"]
    test_evals = [e for e in evals if e["prefix"] == "test"]
    losses = [ln["train/loss"] for ln in lines if "train/loss" in ln]
    print(f"  data: 16 volumes {'x'.join(map(str, shape))} written in {data_s:.2f} s; fit of 3 epochs x 4 steps "
          f"+ its test {fit_s:.2f} s, resumed epoch + its test {resume_s:.2f} s, cli.test "
          f"{test_s:.2f} s on '{card}'")
    print(f"  train step in the fit: {statistics.median(ms):.2f} ms p50, {pct(ms, 0.95):.2f} ms "
          f"p95 by CUDA events ({len(ms)} steps after the first, "
          f"{h['step_ms'][0]:.2f} ms); loader wait a step {statistics.mean(waits):.4f} s mean, "
          f"{max(waits):.4f} s max, first {waits[0]:.4f} s; epochs "
          f"{', '.join(f'{s:.2f}' for s in h['epoch_s'])} s; train loss by epoch "
          f"{', '.join(f'{v:.4f}' for v in losses)}; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"  data module set-up (caching the deterministic chain of 4 train and 2 val "
          f"volumes) {h['setup_s'][0]:.2f} s; checkpoint saves a validation (top-k, "
          f"checkpoints/last, best, last) {', '.join(f'{s:.2f}' for s in h['ckpt_s'])} s")
    print("  validation: " + "; ".join(
        f"{e['windows']} windows in {e['s']:.2f} s ({e['windows'] / e['s']:.2f} windows/s)"
        for e in val_evals))
    print("  test (best.ckpt, Dice + surface distance): " + "; ".join(
        f"{e['s']:.2f} s, surface distance {e['surface_s']:.2f} s "
        f"({e['surface_s'] / e['s']:.1%})" for e in test_evals))
    print(f"  test metrics: dice avg {test_metrics['test_total_dice/avg']:.4f} (CT "
          f"{test_metrics['test_modality0_dice/avg']:.4f}, MR "
          f"{test_metrics['test_modality1_dice/avg']:.4f}), surface distance avg "
          f"{test_metrics['test_total_surface_distance/avg']:.3f} voxels, loss "
          f"{test_metrics['test/loss/avg']:.4f}")
    train_total = {k: sum(c[k] for c in step_counts) for k in PER_WINDOW}
    val_total = {k: sum(e["counts"][k] for e in evals) for k in PER_WINDOW}
    print(f"fit: cli.train fitted the flagship for 3 epochs and a resumed 4th (steps 12..15 at "
          f"lr {want_lr:.3e}), every train step launching {PER_WINDOW} and every evaluate "
          f"PER_WINDOW x its windows with no autograd Function; cli.test on best.ckpt "
          f"reported Dice and surface distance ({time.perf_counter() - t_phase:.1f} s)")
    return {"train": train_total, "eval": val_total}


def unetr_kernels(dev, mem_bw: float, bf16_flops: float) -> None:
    """(a) The kernels at C-UNETR's shapes against their plain versions in
    bf16 and f32, with times beside their bounds: K4 at its ten window
    geometries (`UNETR_CONVS`: the Cin = 1 conv to 16 channels, the brick
    kernel at 16 and 32 output channels, the coarse kernel up to 256 ->
    128 at 12^3), K1 with `[2, 768]` banks and K2 at the ViT's token
    tensor [1, 216, 768] and K1 (`[2, C]` banks) at the four
    projected-residual norm3 tensors, K2's add mode at the three identity
    tails and K3 at the projected-residual tails."""
    gen = torch.Generator().manual_seed(13)
    flush = l2_flush(dev)
    for label, shape, cout, prologue in UNETR_CONVS:
        print(k4_case(label, shape, cout, prologue, dev, gen, mem_bw, bf16_flops)[0])
    for shape in ((1, 216, 768), (1, 96 ** 3, 16), (1, 48 ** 3, 32), (1, 24 ** 3, 64),
                  (1, 12 ** 3, 128)):
        print(k1_case(shape, dev, gen, mem_bw, flush)[0])
    print(k2_case((1, 216, 768), dev, gen, mem_bw, flush, adds=(False,))[0])
    for shape in ((1, 48 ** 3, 32), (1, 24 ** 3, 32), (1, 24 ** 3, 64)):
        print(k2_case(shape, dev, gen, mem_bw, flush, adds=(True,))[0])
    for shape in ((1, 96 ** 3, 16), (1, 48 ** 3, 32), (1, 24 ** 3, 64), (1, 12 ** 3, 128)):
        print(k3_case(shape, dev, gen, mem_bw, flush)[0])


def check_card_logits(label: str, got, want, margin, tol: float | None = None) -> str:
    """The card's logits `got` against the CPU's `want`: finite, within
    `tol` (by default `tolerance`), and the argmax equal at every voxel
    whose top-two `margin` on the CPU exceeds twice the logits' largest
    difference (a nearer tie may flip by rounding), with at most
    `TIE_SHARE` of the voxels that near a tie.  Returns the line's words."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    err = max_err(got, want)
    tol = tolerance(want, torch.float32) if tol is None else tol
    check(err <= tol, f"{label}: card vs CPU {err:.3e} > {tol:.3e}")
    same = got.argmax(-1) == want.argmax(-1)
    clear = margin > 2 * err
    ties = int((~clear).sum())
    check(ties <= TIE_SHARE * clear.numel(), f"{label}: {ties} voxels within 2 x |diff| of "
                                             f"a tie > {TIE_SHARE:g} of them")
    check(bool(same[clear].all()), f"{label}: argmax differs at "
                                   f"{int((~same & clear).sum())} voxels of clear margin")
    return (f"max |diff| {err:.3e} (tol {tol:.3e}), argmax equal on "
            f"{float(same.float().mean()):.6%} ({ties} voxels within 2 x |diff| of a tie)")


def unetr_card_vs_cpu(dev, size: int = 64) -> None:
    """(b) The fs-16 C-UNETR (hidden 768, 12 blocks) at a `size`^3 ROI in
    f32 on the card against the CPU, same weights, through the fused conv
    chain and the unfused path: logits within `tolerance`, and the argmax
    equal at every voxel whose top-two margin on the CPU exceeds twice the
    logits' largest difference (a nearer tie may flip by rounding), with
    at most `TIE_SHARE` of the voxels that near a tie."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.ops.kernels import fused_conv as fc

    cfg = Config(**{**UNETR, "roi_x": size, "roi_y": size, "roi_z": size})
    cpu = model_from_config(cfg, device="cpu")
    gen = torch.Generator().manual_seed(14)
    x = torch.randn((2, size, size, size, 1), generator=gen)
    mods = torch.tensor([0, 1], dtype=torch.int32)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x, mods)
        cpu_s = time.perf_counter() - t0
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    lines = []
    for fused in (True, False):
        card = model_from_config(cfg, device=dev, fused_conv=fused)
        card.load_state_dict(cpu.state_dict())
        fc.launches = 0
        with torch.inference_mode():
            got = card(x.to(dev), mods.to(dev)).cpu()
        name = "fused" if fused else "unfused"
        check(fc.launches == (UNETR_PER_WINDOW["K4"] if fused else 0),
              f"unetr model {name}: {fc.launches} K4 launches")
        lines.append(f"{name} " + check_card_logits(f"unetr model {name}", got, want, margin))
        del card
    print(f"  unetr model: fs16 hidden 768, {size}^3, batch 2, f32 (TF32 off), card vs CPU: "
          + "; ".join(lines) + f" (|logits| <= {float(want.abs().max()):.3f}); "
          f"CPU forward {cpu_s:.1f} s")


def unetr_serve(dev) -> dict:
    """(c) A full-width C-UNETR bundle (bf16, seeded weights) answers a 224^3
    volume (64 windows, gaussian blend, overlap 0.5) through
    `load_bundle(...).predict`: finite logits of the volume's shape, the
    window graph replayed 64 times (nothing launched from Python), a
    replayed window running `UNETR_PER_WINDOW` kernels by name under the
    profiler (`window_graph_kernels`); then a
    profile of one window, which must run exactly those kernels, all the
    CUDA ones.  Returns the kernels of a request."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    cfg = Config(**UNETR)
    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(cfg, model_from_config(cfg, device=dev).state_dict(), tmp)
        served = load_bundle(tmp)
    check(served.compute_dtype == torch.bfloat16, "unetr serve: bundle is not bf16")
    vol = torch.rand((1, 224, 224, 224, 1), generator=torch.Generator().manual_seed(15))
    windows = len(window_starts(vol.shape[1:-1], cfg.roi, cfg.infer_overlap)[1])
    check(windows == 64, f"unetr serve: {windows} windows, want 64")
    served.predict(vol, [1])   # warm-up: the per-shape plans and caches, the capture
    took = []
    for mod in (0, 1):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = served.predict(vol, [mod])
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
        check(tuple(out.shape) == (1, 224, 224, 224, cfg.out_channels),
              f"unetr serve: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "unetr serve: non-finite logits")
        check(launch_counts() == dict.fromkeys(PER_WINDOW, 0),
              f"unetr serve modality {mod}: launched {launch_counts()} from Python")
    counts = window_graph_kernels(served, vol, 1, UNETR_PER_WINDOW, windows)
    print(f"  unetr serve: 224^3, {windows} windows, modality 0 / 1: {took[0]:.3f} / "
          f"{took[1]:.3f} s ({windows / took[0]:.2f} / {windows / took[1]:.2f} windows/s); "
          f"launches {counts}")
    profile_window(served, dev, per=UNETR_PER_WINDOW, k4=UNETR_WINDOW_K4,
                   label="one 96^3 C-UNETR window")
    return counts


def unetr_fit(dev, card: str, shape=(192, 192, 160)) -> dict:
    """(e) `cli.train.main --model_name unetr` at full width on
    `phase_fit`'s synthetic CT + MR set: 2 epochs of one 96^3 crop a volume,
    a validation each, the test of best.ckpt; then `cli.test.main` on
    best.ckpt.  Every train step must launch one C-UNETR window's kernels,
    every evaluate `UNETR_PER_WINDOW` x its windows with no autograd
    Function; metric names and values as `phase_fit` checks them.  Returns
    the launches in train steps and in evaluations."""
    from miseg_tpu_torch.cli import test as cli_test
    from miseg_tpu_torch.cli import train as cli_train
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        root = fit_data(tmp, shape, 6)
        cfg = Config(**{**UNETR, "data_dirs": [str(root)] * 2,
                        "json_lists": ["CT.json", "MR.json"], "max_epochs": 2,
                        "check_val_every_n_epoch": 1, "scheduler": "warmup_cosine",
                        "warmup_epochs": 1, "batch_size": 1, "patches_training_sample": 1,
                        "num_workers": 2, "cache_num": 8, "log_every_n_steps": 1,
                        "default_root_dir": str(Path(tmp) / "runs"),
                        "experiment_name": "unetr"})
        with counting_fit() as rec:
            t0 = time.perf_counter()
            trainer, state, test_metrics = cli_train.main(cfg, device=dev)
            fit_s = time.perf_counter() - t0
            workdir = Path(cfg.default_root_dir) / "unetr"
            t0 = time.perf_counter()
            cli_metrics = cli_test.main(cfg.replace(ckpt_path=str(workdir / "best.ckpt")),
                                        device=dev)
            test_s = time.perf_counter() - t0
        check(len(rec["steps"]) == 8, f"unetr fit: {len(rec['steps'])} train steps in 2 epochs")
        check_fit_launches("unetr fit", rec, UNETR_PER_WINDOW)
        lines = [json.loads(ln) for ln in open(workdir / "metrics.jsonl")]
        vals = [ln for ln in lines if "val/loss/avg" in ln]
        check(len(vals) == 2, f"unetr fit: {len(vals)} validations in 2 epochs")
        for ln in vals:
            check_metrics(f"unetr fit val epoch {ln['step']}",
                          {k: v for k, v in ln.items() if k not in ("ts", "step")},
                          "val", cfg.out_channels, False)
        check_metrics("unetr fit test", test_metrics, "test", cfg.out_channels, True)
        check_metrics("unetr cli.test", cli_metrics, "test", cfg.out_channels, True)
        check(same_metrics(cli_metrics, test_metrics),
              "unetr fit: cli.test on best.ckpt differs from the run's own test of best.ckpt")
        n_params = len(state.params)
        ck = load_checkpoint(workdir / "best.ckpt")
        check(len(ck["params"]) == n_params and all(bool(torch.isfinite(v).all())
                                                    for v in ck["params"].values()),
              f"unetr fit: best.ckpt does not reload {n_params} finite parameters")
    h = trainer.history
    evals = rec["evals"]
    print(f"  unetr fit: 2 epochs x 4 steps + its test {fit_s:.2f} s, cli.test {test_s:.2f} s on "
          f"'{card}'; step ms by CUDA events {', '.join(f'{v:.1f}' for v in h['step_ms'])}; "
          f"checkpoint saves a validation {', '.join(f'{s:.2f}' for s in h['ckpt_s'])} s; "
          + "; ".join(f"{e['prefix']} {e['windows']} windows {e['s']:.2f} s" for e in evals)
          + f"; test dice avg {test_metrics['test_total_dice/avg']:.4f}, train losses "
          + ", ".join(f"{ln['train/loss']:.4f}" for ln in lines if "train/loss" in ln))
    return {"train": {k: sum(c[k] for c in rec["steps"]) for k in UNETR_PER_WINDOW},
            "eval": {k: sum(e["counts"][k] for e in evals) for k in UNETR_PER_WINDOW}}


def phase_unetr(dev, card: str, mem_bw: float, bf16_flops: float) -> dict:
    """C-UNETR, the JAX package's default model, on every entry point the
    flagship runs: (a) `unetr_kernels`, (b) `unetr_card_vs_cpu`, (c)
    `unetr_serve`, (d) its full-width bf16 train step (`train_full`), (e)
    `unetr_fit`.  Returns the launches of a served window, a train step,
    and the fit's train steps and evaluations."""
    t0 = time.perf_counter()
    unetr_kernels(dev, mem_bw, bf16_flops)
    unetr_card_vs_cpu(dev)
    served = unetr_serve(dev)
    step = train_full(dev, card, model=UNETR, per=UNETR_PER_WINDOW, k4=UNETR_WINDOW_K4)
    fit = unetr_fit(dev, card)
    print(f"unetr: C-UNETR (fs16, hidden 768, 12 blocks, {UNETR_PER_WINDOW} a window) served, "
          f"trained and fitted through the kernels ({time.perf_counter() - t0:.1f} s)")
    return {"window": {k: v // 64 for k, v in served.items()}, "step": step, "fit": fit}


def unet_kernels(dev, mem_bw: float) -> None:
    """(a) K1 (with `[2, C]` banks) and K2 in its no-add, no-activation mode
    at every norm shape of the two UNets' windows (`UNET_NORM_SHAPES`: C =
    6 at 96^3, which no vector width divides, up to 512 at 12^3) against
    their plain versions in bf16 and f32, with times beside their byte
    bounds (K2 beside `torch.addcmul`)."""
    gen = torch.Generator().manual_seed(16)
    flush = l2_flush(dev)
    for shape in UNET_NORM_SHAPES:
        print(k1_case(shape, dev, gen, mem_bw, flush)[0])
        print(k2_affine_case(shape, dev, gen, mem_bw, flush)[0])


def unet_card_vs_cpu(dev, size: int = 64) -> None:
    """(b) Both UNets at a `size`^3 ROI in f32, card against CPU, on the
    same seeded weights: logits (`check_card_logits`) and the window's
    launches; then a C-UNet with `batch` norms: one AdamW step (loss within
    1e-5, every gradient leaf within 5e-5 and their sum within 1e-3 as
    `train_card_vs_cpu`, and in f64 each leaf relative to its size
    (`f64_gradients_card_vs_cpu`), parameters after it within rtol 1e-4 /
    atol 2.5e-4, the new f32 running statistics within rtol 1e-4 / atol
    1e-6), and the eval-mode logits of the CPU's updated state on both."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.train.engine import Trainer

    gen = torch.Generator().manual_seed(17)
    x = torch.randn((2, size, size, size, 1), generator=gen)
    mods = torch.tensor([0, 1], dtype=torch.int32)
    roi = {"roi_x": size, "roi_y": size, "roi_z": size}
    for label, model, per in (("C-UNet", CUNET, CUNET_PER_WINDOW),
                              ("unet_vanilla", VANILLA, VANILLA_PER_WINDOW)):
        cfg = Config(**{**model, **roi})
        cpu = model_from_config(cfg, device="cpu")
        card = model_from_config(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        with torch.inference_mode():
            t0 = time.perf_counter()
            want = cpu(x, mods)
            cpu_s = time.perf_counter() - t0
            reset_launches()
            got = card(x.to(dev), mods.to(dev)).cpu()
        counts = launch_counts()
        check(counts == per, f"{label} model: launched {counts}, want {per}")
        top2 = want.topk(2, dim=-1).values
        words = check_card_logits(f"{label} model", got, want, top2[..., 0] - top2[..., 1])
        print(f"  {label} model {size}^3, batch 2, f32 (TF32 off), card vs CPU: {words} "
              f"(|logits| <= {float(want.abs().max()):.3f}); launches {counts}; CPU forward "
              f"{cpu_s:.1f} s")
        del cpu, card

    cfg = Config(**{**CUNET, **roi, "encoder_norm_name": "batch", "decoder_norm_name": "batch",
                    "no_amp": True})
    batch = {"image": x, "label": torch.randint(0, cfg.out_channels, (2, size, size, size),
                                                generator=gen), "modality": mods}
    cpu, card = Trainer(cfg, device="cpu"), Trainer(cfg, device=dev)
    states = {"cpu": cpu.init_state()}
    start = {k: v.detach().clone() for k, v in cpu.model.state_dict().items()}
    states["card"] = card.init_state(start)
    losses = {}
    for name, trainer in (("cpu", cpu), ("card", card)):
        states[name], loss = trainer.train_step(states[name], batch)
        losses[name] = float(loss)
    loss_err = abs(losses["card"] - losses["cpu"])
    check(loss_err <= 1e-5, f"C-UNet batch-norm step: card vs CPU loss {loss_err:.3e} > 1e-5")
    gaps = {}
    for n, p in states["cpu"].params.items():
        q = states["card"].params[n]
        check(p.grad is not None and q.grad is not None,
              f"C-UNet batch-norm step: {n} has no gradient")
        check(bool(torch.isfinite(q.grad).all()), f"C-UNet batch-norm step: {n}'s gradient "
                                                  f"on the card is not finite")
        gaps[n] = max_err(q.grad.cpu(), p.grad)
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= 5e-5 and sum(gaps.values()) <= 1e-3,
          f"C-UNet batch-norm step: gradient gap worst {worst} {gaps[worst]:.3e} (tol 5e-5), "
          f"summed {sum(gaps.values()):.3e} (tol 1e-3)")
    worst_f64 = f64_gradients_card_vs_cpu(cfg, dev, start, batch)
    worst_p = max(float(((states["card"].params[n].detach().cpu() - p.detach()).abs()
                         - (2.5e-4 + 1e-4 * p.detach().abs())).max())
                  for n, p in states["cpu"].params.items())
    check(worst_p <= 0.0, f"C-UNet batch-norm step: parameters after the step exceed rtol "
                          f"1e-4 / atol 2.5e-4 by {worst_p:.3e}")
    bufs = states["cpu"].buffers
    check(len(bufs) == 2 * 13 and all(b.dtype == torch.float32 for b in
                                      states["card"].buffers.values()),
          f"C-UNet batch-norm step: {len(bufs)} running statistics on the card, want 26 f32")
    worst_b = max(float(((states["card"].buffers[n].cpu() - b).abs()
                         - (1e-6 + 1e-4 * b.abs())).max()) for n, b in bufs.items())
    check(worst_b <= 0.0, f"C-UNet batch-norm step: running statistics exceed rtol 1e-4 / "
                          f"atol 1e-6 by {worst_b:.3e}")
    card.restore(states["card"], {"params": cpu.state_dict(states["cpu"])})
    logits = {}
    for name, trainer in (("cpu", cpu), ("card", card)):
        with torch.inference_mode():
            logits[name] = trainer.make_inferer()(
                x.to(trainer.device), mods.to(trainer.device)).cpu()
    want = logits["cpu"]
    top2 = want.topk(2, dim=-1).values
    words = check_card_logits("C-UNet batch-norm eval", logits["card"], want,
                              top2[..., 0] - top2[..., 1])
    print(f"  C-UNet batch norms {size}^3 f32 train step, card vs CPU: loss {losses['card']:.6f} "
          f"|diff| {loss_err:.2e} (tol 1e-05); gradient gap over {len(gaps)} leaves summed "
          f"{sum(gaps.values()):.3e} (tol 1e-03), worst {worst} {gaps[worst]:.2e} (tol 5e-05; "
          f"{worst_f64}); "
          f"parameters within rtol 1e-4 / atol 2.5e-4 and "
          f"the 26 running statistics (f32) within rtol 1e-4 / atol 1e-6 after the step; "
          f"eval logits on the CPU's updated state {words}")


def f64_gradients_card_vs_cpu(cfg, dev, state_dict, batch) -> str:
    """`cfg`'s model in f64 and train mode on the card and on the CPU, from
    `state_dict` (a batch norm's statistics stay f32 inside, and the loss
    is f32): the loss of `batch` and every parameter's gradient, each
    within `F64_GRAD_RTOL` of the leaf's largest element + `F64_GRAD_ATOL`.
    Zeroing or negating any leaf would break that bound but for those the
    CPU leaves within `F64_GRAD_ATOL` of 0, which must be biases of convs
    feeding a norm.  Returns the line's words."""
    from miseg_tpu_torch.losses import loss_from_config
    from miseg_tpu_torch.models import model_from_config

    grads, losses = {}, {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        model = model_from_config(cfg, device=device, dtype=torch.float64)
        model.load_state_dict(state_dict)
        model.train()
        logits = model(batch["image"].to(device, torch.float64), batch["modality"].to(device))
        loss = loss_from_config(cfg)(logits, batch["label"].to(device))
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        del model
    sizes = {n: float(g.abs().max()) for n, g in grads["cpu"].items()}
    gaps = {n: max_err(grads["card"][n], g) for n, g in grads["cpu"].items()}
    over = {n: gaps[n] - (F64_GRAD_RTOL * sizes[n] + F64_GRAD_ATOL) for n in gaps}
    rel = {n: gaps[n] / sizes[n] for n in gaps if sizes[n] > F64_GRAD_ATOL}
    worst = max(rel, key=rel.get)
    # (the loss itself is f32: the losses cast the logits)
    check(abs(losses["card"] - losses["cpu"]) <= 1e-5,
          f"f64 step: card vs CPU loss {abs(losses['card'] - losses['cpu']):.3e} > 1e-5")
    check(max(over.values()) <= 0.0,
          f"f64 step: {max(over, key=over.get)}'s gradient gap exceeds {F64_GRAD_RTOL:g} of "
          f"its size + {F64_GRAD_ATOL:g} by {max(over.values()):.3e}")
    dead = [n for n, v in sizes.items() if v <= F64_GRAD_ATOL / (1 - F64_GRAD_RTOL)]
    check(all(n.endswith("bias") for n in dead), f"f64 step: gradients within "
                                                 f"{F64_GRAD_ATOL:g} of 0: {dead}")
    return (f"in f64 every leaf within {F64_GRAD_RTOL:g} of its size + {F64_GRAD_ATOL:g}, "
            f"worst {worst} {rel[worst]:.2e} of its size, loss |diff| "
            f"{abs(losses['card'] - losses['cpu']):.1e}; {len(dead)} conv biases before a norm "
            f"at 0, the other leaves' smallest gradient "
            f"{min(v for n, v in sizes.items() if n not in dead):.2e}")


def unet_serve(dev) -> dict:
    """(c) A bf16 UNetVanilla bundle (README recipe, seeded weights) answers a
    224^3 volume (64 windows, gaussian blend, overlap 0.5) through
    `load_bundle(...).predict` through the window graph, replayed 64 times
    with nothing launched from Python, a replayed window running
    `VANILLA_PER_WINDOW` kernels by name under the profiler
    (`window_graph_kernels`), then a profiled window that ran exactly
    those kernels; a bf16 C-UNet bundle's window program launches
    `CUNET_PER_WINDOW`, its replayed window runs them, and its profile
    passes the same check.  Returns the kernels of a window of each."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    out = {}
    for label, model, per in (("unet_vanilla", VANILLA, VANILLA_PER_WINDOW),
                              ("C-UNet", CUNET, CUNET_PER_WINDOW)):
        cfg = Config(**model)
        with tempfile.TemporaryDirectory() as tmp:
            save_bundle(cfg, model_from_config(cfg, device=dev).state_dict(), tmp)
            served = load_bundle(tmp)
        check(served.compute_dtype == torch.bfloat16, f"{label} serve: bundle is not bf16")
        if label == "unet_vanilla":
            vol = torch.rand((1, 224, 224, 224, 1), generator=torch.Generator().manual_seed(18))
            windows = len(window_starts(vol.shape[1:-1], cfg.roi, cfg.infer_overlap)[1])
            check(windows == 64, f"{label} serve: {windows} windows, want 64")
            served.predict(vol, [1])   # warm-up: the per-shape plans and caches, the capture
            took = []
            for mod in (0, 1):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                logits = served.predict(vol, [mod])
                torch.cuda.synchronize()
                took.append(time.perf_counter() - t0)
                check(tuple(logits.shape) == (1, 224, 224, 224, cfg.out_channels),
                      f"{label} serve: shape {tuple(logits.shape)}")
                check(bool(torch.isfinite(logits).all()), f"{label} serve: non-finite logits")
                check(launch_counts() == dict.fromkeys(PER_WINDOW, 0),
                      f"{label} serve modality {mod}: launched {launch_counts()} from Python")
            counts = window_graph_kernels(served, vol, 1, per, windows)
            print(f"  {label} serve: 224^3, {windows} windows, modality 0 / 1: {took[0]:.3f} / "
                  f"{took[1]:.3f} s ({windows / took[0]:.2f} / {windows / took[1]:.2f} "
                  f"windows/s); launches {counts}")
            out[label] = {k: v // windows for k, v in counts.items()}
        else:
            window = torch.rand((1, 96, 96, 96, 1),
                                generator=torch.Generator().manual_seed(19)).to(dev)
            mods = torch.tensor([1], dtype=torch.int32, device=dev)
            served(window, [0])
            torch.cuda.synchronize()
            reset_launches()
            with torch.inference_mode():
                logits = served.window_fn(window, mods)
            torch.cuda.synchronize()
            counts = launch_counts()
            check(counts == per, f"{label} window: launched {counts}, want {per}")
            check(bool(torch.isfinite(logits).all()), f"{label} window: non-finite logits")
            kernels = device_kernels(lambda: served(window, mods), per)
            check(kernels == per, f"{label} served window: kernels by name {kernels}, "
                                  f"want {per}")
            out[label] = kernels
        profile_window(served, dev, per=per, k4=UNET_WINDOW_K4,
                       label=f"one 96^3 {label} window")
        del served
    return out


def unet_fit(dev, card: str, shape=(192, 192, 160)) -> dict:
    """(e) `cli.train.main` of UNetVanilla at the README recipe (8 classes)
    on a synthetic CT + MR set of `phase_fit`'s shape and split, with 8
    classes: 2 epochs of one 96^3 crop a volume, a validation each, the
    test of best.ckpt; `cli.test.main` on best.ckpt; then
    `cli.predict_whs.main` over best.ckpt on the CT test scan: a uint16
    label file in the scan's grid with its affine, holding MM-WHS values
    only.  The launch, metric and Function checks are `unetr_fit`'s.
    Returns the launches in train steps and in evaluations."""
    from miseg_tpu_torch.cli import predict_whs
    from miseg_tpu_torch.cli import test as cli_test
    from miseg_tpu_torch.cli import train as cli_train
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.data.nifti import load_nifti
    from miseg_tpu_torch.train.checkpoint import load_checkpoint

    per = VANILLA_PER_WINDOW
    with tempfile.TemporaryDirectory() as tmp:
        root = fit_data(tmp, shape, 8)
        cfg = Config(**{**VANILLA, "data_dirs": [str(root)] * 2,
                        "json_lists": ["CT.json", "MR.json"], "max_epochs": 2,
                        "check_val_every_n_epoch": 1, "scheduler": "warmup_cosine",
                        "warmup_epochs": 1, "batch_size": 1, "patches_training_sample": 1,
                        "num_workers": 2, "cache_num": 8, "log_every_n_steps": 1,
                        "default_root_dir": str(Path(tmp) / "runs"),
                        "experiment_name": "vanilla"})
        with counting_fit() as rec:
            t0 = time.perf_counter()
            trainer, state, test_metrics = cli_train.main(cfg, device=dev)
            fit_s = time.perf_counter() - t0
            workdir = Path(cfg.default_root_dir) / "vanilla"
            best = cfg.replace(ckpt_path=str(workdir / "best.ckpt"))
            t0 = time.perf_counter()
            cli_metrics = cli_test.main(best, device=dev)
            test_s = time.perf_counter() - t0
        check(len(rec["steps"]) == 8, f"vanilla fit: {len(rec['steps'])} train steps in 2 epochs")
        check_fit_launches("vanilla fit", rec, per)
        lines = [json.loads(ln) for ln in open(workdir / "metrics.jsonl")]
        vals = [ln for ln in lines if "val/loss/avg" in ln]
        check(len(vals) == 2, f"vanilla fit: {len(vals)} validations in 2 epochs")
        for ln in vals:
            check_metrics(f"vanilla fit val epoch {ln['step']}",
                          {k: v for k, v in ln.items() if k not in ("ts", "step")},
                          "val", cfg.out_channels, False)
        check_metrics("vanilla fit test", test_metrics, "test", cfg.out_channels, True)
        check_metrics("vanilla cli.test", cli_metrics, "test", cfg.out_channels, True)
        check(same_metrics(cli_metrics, test_metrics),
              "vanilla fit: cli.test on best.ckpt differs from the run's own test of best.ckpt")
        ck = load_checkpoint(workdir / "best.ckpt")
        check(ck["params"].keys() == trainer.model.state_dict().keys()
              and all(bool(torch.isfinite(v).all()) for v in ck["params"].values()),
              f"vanilla fit: best.ckpt does not reload the model's {len(state.params)} finite "
              f"parameters")

        reset_launches()
        t0 = time.perf_counter()
        written = predict_whs.main(best, data_dir=str(root), json_list="CT.json",
                                   result_dir=str(Path(tmp) / "predictions"), device=dev)
        predict_s = time.perf_counter() - t0
        counts = launch_counts()
        scan = json.loads((root / "CT.json").read_text())["test"][0]
        scan = load_nifti(root / (scan["image"] if isinstance(scan, dict) else scan))
        check(len(written) == 1, f"predict_whs wrote {len(written)} files, want 1")
        pred = load_nifti(written[0])
        values = set(torch.unique(torch.from_numpy(pred.data.astype("int64"))).tolist())
        check(pred.data.dtype.name == "uint16" and pred.data.shape == scan.data.shape
              and bool((pred.affine == scan.affine).all()),
              f"predict_whs: {pred.data.dtype} {pred.data.shape} in a grid other than the "
              f"scan's {scan.data.shape}")
        check(values <= {0, *predict_whs.MMWHS_LABEL_MAP.values()},
              f"predict_whs: label values {sorted(values)} outside MM-WHS's")
        check(counts["K1"] == counts["K2"] > 0 and counts["K1"] % per["K1"] == 0
              and not any(counts[k] for k in ("K1 fold", "K3", "K4", "K5")),
              f"predict_whs launched {counts}; want a multiple of {per}")
    h = trainer.history
    evals = rec["evals"]
    print(f"  vanilla fit: 2 epochs x 4 steps + its test {fit_s:.2f} s, cli.test {test_s:.2f} s "
          f"on '{card}'; step ms by CUDA events {', '.join(f'{v:.1f}' for v in h['step_ms'])}; "
          f"checkpoint saves a validation {', '.join(f'{s:.2f}' for s in h['ckpt_s'])} s; "
          + "; ".join(f"{e['prefix']} {e['windows']} windows {e['s']:.2f} s" for e in evals)
          + f"; test dice avg {test_metrics['test_total_dice/avg']:.4f}, train losses "
          + ", ".join(f"{ln['train/loss']:.4f}" for ln in lines if "train/loss" in ln))
    print(f"  predict_whs over best.ckpt: {scan.data.shape} scan -> uint16 labels "
          f"{sorted(values)} in its grid in {predict_s:.2f} s, {counts['K1'] // per['K1']} "
          f"windows' launches")
    return {"train": {k: sum(c[k] for c in rec["steps"]) for k in per},
            "eval": {k: sum(e["counts"][k] for e in evals) for k in per}}


def phase_unet(dev, card: str, mem_bw: float) -> dict:
    """C-UNet and UNetVanilla, the residual UNets, on every entry point:
    (a) `unet_kernels`, (b) `unet_card_vs_cpu`, (c) `unet_serve`, (d) their
    full-width bf16 train steps (`train_full`), (e) `unet_fit`.  Returns
    the launches of each model's window and step, and of UNetVanilla's
    fit."""
    t0 = time.perf_counter()
    unet_kernels(dev, mem_bw)
    unet_card_vs_cpu(dev)
    window = unet_serve(dev)
    steps = {label: train_full(dev, card, model=model, per=per, k4=UNET_WINDOW_K4)
             for label, model, per in (("C-UNet", CUNET, CUNET_PER_WINDOW),
                                       ("unet_vanilla", VANILLA, VANILLA_PER_WINDOW))}
    fit = unet_fit(dev, card)
    print(f"unet: C-UNet ({CUNET_PER_WINDOW['K1']} K1 + K2 a window) and UNetVanilla "
          f"({VANILLA_PER_WINDOW['K1']}) served, trained and fitted through K1 and K2 "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"window": window, "step": steps, "fit": fit}


# the flagship fine-tuned from MONAI's Swin-ViT with activation recompute
FINETUNE = {**FLAGSHIP, "model_name": "pre_swin_unetr", "use_checkpoint": True}


def monai_swin_vit_file(path: Path, cfg, seed: int) -> dict:
    """Write a MONAI-layout `model_swinvit.pt` at the swinViT widths of
    `cfg`'s model, from a seed: `module.` prefix, no `swinViT.`,
    `layersK.0.blocks.J`, `fc1`/`fc2`, `[C]` LayerNorm rows, torch layouts,
    the position indices (weights ~ N(0, 1/fan_in), norm weights ~
    1 + N(0, 0.1^2), rel-pos tables ~ N(0, 0.02^2), biases ~ N(0, 0.1^2)).
    Returns the port-named tensors the file holds (relative to swinViT)."""
    import re

    from miseg_tpu_torch.models import model_from_config

    gen = torch.Generator().manual_seed(seed)
    model = model_from_config(cfg, device="meta")
    sd, want = {}, {}
    for name, p in model.swinViT.state_dict().items():
        shape = p.shape[-1:] if name.endswith((".scale", ".bias")) and p.ndim == 2 else p.shape
        v = torch.randn(tuple(shape), generator=gen)
        if name.endswith("relative_position_bias_table"):
            v = 0.02 * v
        elif name.endswith("weight") and v.ndim >= 2:
            v = v / math.sqrt(math.prod(v.shape[1:]))
        else:
            v = (1.0 if name.endswith("scale") else 0.0) + 0.1 * v
        key = re.sub(r"(layers\d+)\.", r"\1.0.", name)
        key = re.sub(r"blocks_(\d+)", r"blocks.\1", key).replace(".scale", ".weight")
        key = key.replace("linear1", "fc1").replace("linear2", "fc2")
        sd["module." + key] = v
        if key.endswith("attn.qkv.weight"):
            sd["module." + key.replace("qkv.weight", "relative_position_index")] = torch.zeros(
                343 * 343, dtype=torch.int64)
        want[name] = v
    torch.save({"state_dict": sd}, path)
    return want


def reference_ckpt(path: Path, state_dict: dict, epoch: int) -> None:
    """A Lightning `.ckpt` of a SwinUNETR state dict in the reference's
    naming: `model.` prefix, `layersK.0.blocks.J`, `transp_conv.conv.weight`,
    conditional-norm rows `norms.S.weight`/`.bias`, a norm's `weight`, the
    blocks' `relative_position_index` buffers."""
    import re

    sd = {}
    for name, v in state_dict.items():
        key = re.sub(r"(layers\d+)\.", r"\1.0.", name)
        key = re.sub(r"blocks_(\d+)", r"blocks.\1", key)
        key = re.sub(r"transp_conv\.(weight|bias)$", r"transp_conv.conv.\1", key)
        module, leaf = key.rsplit(".", 1)
        if leaf in ("scale", "bias") and v.ndim == 2:
            kind = "weight" if leaf == "scale" else "bias"
            sd.update({f"model.{module}.norms.{s}.{kind}": v[s].clone()
                       for s in range(v.shape[0])})
            continue
        sd[f"model.{module}.{'weight' if leaf == 'scale' else leaf}"] = v
        if key.endswith("attn.qkv.weight"):
            sd[f"model.{key[:-len('qkv.weight')]}relative_position_index"] = torch.zeros(
                343 * 343, dtype=torch.int64)
    torch.save({"state_dict": sd, "epoch": epoch, "global_step": 8,
                "hyper_parameters": {"model_name": "pre_swin_unetr", "lr": 1e-4}}, path)


def finetune_fit(dev, card: str, root: Path, swin_path: Path, want: dict) -> dict:
    """(1)-(2) `cli.train.main --model_name pre_swin_unetr --pre_swin <file>
    --use_checkpoint`, 2 epochs on `phase_fit`'s data set.  Before the
    first step the loaded swinViT tensors equal the file's bitwise, and the
    shape-skipped ones are exactly the `[2, C]` norm banks, at their init;
    each train step's forward launches `PER_WINDOW` and its backward, the
    recompute, `RECOMPUTE_PER_STEP`; every evaluate `PER_WINDOW` x its
    windows with no autograd Function.  Returns the trainer, the config,
    the launches and the step times."""
    import re

    from miseg_tpu_torch.cli import train as cli_train
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train import engine
    from miseg_tpu_torch.train.pretrained import (load_report, read_torch_file,
                                                  swin_vit_state_dict)

    cfg = Config(**{**FINETUNE, "pre_swin": str(swin_path), "data_dirs": [str(root)] * 2,
                    "json_lists": ["CT.json", "MR.json"], "max_epochs": 2,
                    "check_val_every_n_epoch": 1, "scheduler": "warmup_cosine",
                    "warmup_epochs": 1, "batch_size": 1, "patches_training_sample": 1,
                    "num_workers": 2, "cache_num": 8, "log_every_n_steps": 1,
                    "default_root_dir": str(root.parent / "runs"),
                    "experiment_name": "finetune"})
    seen, forward = {}, []
    fresh_state, apply_fn = engine.Trainer.fresh_state, engine.Trainer.apply_fn

    def checked_fresh_state(self):
        state = fresh_state(self)
        swin = {n[len("swinViT."):]: p for n, p in state.params.items()
                if n.startswith("swinViT.")}
        report = load_report(swin, swin_vit_state_dict(read_torch_file(swin_path)))
        seen.update(report, bitwise=all(torch.equal(swin[n].cpu(), want[n])
                                        for n in report["loaded"]),
                    init=all(bool((swin[n] == (1.0 if n.endswith("scale") else 0.0)).all())
                             for n, _, _ in report["skipped"]),
                    norms=sorted(n for n in swin if re.search(r"norm\d?\.(scale|bias)$", n)))
        return state

    def counted_apply(self, *args):
        out = apply_fn(self, *args)
        forward.append(launch_counts())
        return out

    engine.Trainer.fresh_state, engine.Trainer.apply_fn = checked_fresh_state, counted_apply
    try:
        with counting_fit() as rec:
            t0 = time.perf_counter()
            trainer, state, test_metrics = cli_train.main(cfg, device=dev)
            fit_s = time.perf_counter() - t0
    finally:
        engine.Trainer.fresh_state, engine.Trainer.apply_fn = fresh_state, apply_fn
    check(bool(seen), "finetune: fresh_state never ran")
    check(seen["bitwise"] and len(seen["loaded"]) == len(want) - len(seen["norms"]),
          f"finetune: {len(seen['loaded'])} swinViT tensors loaded (want "
          f"{len(want) - len(seen['norms'])}), equal to the file's: {seen['bitwise']}")
    check(sorted(n for n, _, _ in seen["skipped"]) == seen["norms"] and seen["init"],
          f"finetune: shape-skipped {[n for n, _, _ in seen['skipped']][:4]}..., want the "
          f"{len(seen['norms'])} [2, C] norm banks at their init")
    check(len(rec["steps"]) == 8 and len(forward) == 8,
          f"finetune: {len(rec['steps'])} train steps, {len(forward)} forwards in 2 epochs")
    check(all(f == PER_WINDOW for f in forward),
          f"finetune: a train step's forward launched {forward[0]}, want {PER_WINDOW}")
    recompute = [{k: s[k] - f[k] for k in s} for s, f in zip(rec["steps"], forward)]
    check(all(r == RECOMPUTE_PER_STEP for r in recompute),
          f"finetune: a train step's backward (the recompute) launched {recompute[0]}, want "
          f"{RECOMPUTE_PER_STEP}")
    check_fit_launches("finetune", rec, PER_WINDOW,
                       {k: PER_WINDOW[k] + RECOMPUTE_PER_STEP[k] for k in PER_WINDOW})
    check_metrics("finetune test", test_metrics, "test", cfg.out_channels, True)
    ms = trainer.history["step_ms"][1:]
    print(f"  finetune: swinViT from a MONAI-layout file: {len(seen['loaded'])} tensors "
          f"loaded bitwise, {len(seen['skipped'])} [2, C] norm banks shape-skipped at init; "
          f"2 epochs x 4 steps + test {fit_s:.2f} s on '{card}'; step with recompute "
          f"{statistics.median(ms):.2f} ms p50, {max(ms):.2f} max by CUDA events (first "
          f"{trainer.history['step_ms'][0]:.2f}); launches a step: forward {forward[0]}, "
          f"backward (recompute) {recompute[0]}; "
          + "; ".join(f"{e['prefix']} {e['windows']} windows {e['s']:.2f} s"
                      for e in rec["evals"])
          + f"; test dice avg {test_metrics['test_total_dice/avg']:.4f}")
    return {"trainer": trainer, "cfg": cfg, "state": state,
            "train": {k: sum(c[k] for c in rec["steps"]) for k in PER_WINDOW},
            "eval": {k: sum(e["counts"][k] for e in rec["evals"]) for k in PER_WINDOW},
            "step_ms": statistics.median(ms)}


def recompute_card_vs_card(dev, size: int = 64) -> None:
    """(3) One f32 step of the fs-48 model at `size`^3 with and without
    `use_checkpoint`, dropout 0.1, attention dropout 0.1 and drop-path 0.2,
    the trainers' dropout generators seeded alike: loss within 1e-5, every
    gradient leaf within 5e-5 and their sum within 1e-3."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    base = {**FLAGSHIP, "roi_x": size, "roi_y": size, "roi_z": size, "no_amp": True,
            "dropout_rate": 0.1, "attn_drop_rate": 0.1, "dropout_path_rate": 0.2}
    gen = torch.Generator().manual_seed(10)
    batch = {"image": torch.randn((1, size, size, size, 1), generator=gen),
             "label": torch.randint(0, 6, (1, size, size, size), generator=gen),
             "modality": torch.tensor([1], dtype=torch.int32)}
    weights, losses, grads = None, {}, {}
    for rc in (False, True):
        trainer = Trainer(Config(**base, use_checkpoint=rc), device=dev)
        state = trainer.init_state(weights)
        weights = weights or {n: p.detach().clone() for n, p in trainer.model.state_dict().items()}
        loss, g = trainer.value_and_grad(state, batch)
        losses[rc], grads[rc] = float(loss), {n: v.detach().clone() for n, v in g.items()}
        del trainer, state, g
    gaps = {n: max_err(grads[True][n], grads[False][n]) for n in grads[False]}
    worst = max(gaps, key=gaps.get)
    loss_err = abs(losses[True] - losses[False])
    check(loss_err <= 1e-5 and gaps[worst] <= 5e-5 and sum(gaps.values()) <= 1e-3,
          f"recompute {size}^3: loss |diff| {loss_err:.3e} (tol 1e-5), gradient worst {worst} "
          f"{gaps[worst]:.3e} (tol 5e-5), summed {sum(gaps.values()):.3e} (tol 1e-3)")
    print(f"  recompute, card vs card: fs48 {size}^3 f32 step with dropout 0.1 / attention "
          f"dropout 0.1 / drop-path 0.2, use_checkpoint on vs off: loss {losses[True]:.6f} "
          f"|diff| {loss_err:.2e}; gradient gap over {len(gaps)} leaves summed "
          f"{sum(gaps.values()):.3e} (tol 1e-03), worst {worst} {gaps[worst]:.2e} (tol 5e-05)")


def step_peak(dev, cfg, batch_size: int) -> int:
    """Bytes the card holds at the peak of a train step of `cfg` on one
    ROI (96^3) at `batch_size` (after a warm-up step), above what it held
    before the trainer was made."""
    import gc

    from miseg_tpu_torch.train.engine import Trainer

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator().manual_seed(11)
    image, label = synthetic_case(cfg.roi_x, cfg.out_channels, gen)
    batch = {"image": image.repeat(batch_size, 1, 1, 1, 1).to(dev),
             "label": label.repeat(batch_size, 1, 1, 1).to(dev),
             "modality": (torch.arange(batch_size, dtype=torch.int32) % 2).to(dev)}
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def recompute_memory(dev) -> dict:
    """(4) The peak of a 96^3 bf16 step at batch 2 with and without
    `use_checkpoint` (recompute must lower it), and at batch 1 without:
    the tuner's memory budget comes from these."""
    from miseg_tpu_torch.config import Config

    peaks = {(bs, rc): step_peak(dev, Config(**FLAGSHIP, use_checkpoint=rc), bs)
             for bs, rc in ((1, False), (2, False), (2, True))}
    check(peaks[2, True] < peaks[2, False],
          f"memory: batch-2 peak with recompute {peaks[2, True] / 2 ** 30:.2f} GiB is not below "
          f"{peaks[2, False] / 2 ** 30:.2f} GiB without")
    print(f"  memory: 96^3 bf16 step peak above the process's baseline: batch 1 "
          f"{peaks[1, False] / 2 ** 30:.3f} GiB, batch 2 {peaks[2, False] / 2 ** 30:.3f} GiB "
          f"without recompute, {peaks[2, True] / 2 ** 30:.3f} GiB with "
          f"({1 - peaks[2, True] / peaks[2, False]:.1%} lower)")
    return peaks


def reference_ckpt_test(dev, fit: dict, root: Path) -> None:
    """(5) The fine-tuned `best.ckpt` written as a reference-layout
    Lightning `.ckpt` (`reference_ckpt`): its ingest equals `best.ckpt`'s
    bitwise, and `cli.test` on it reports the metrics of `cli.test` on
    `best.ckpt`."""
    from miseg_tpu_torch.cli import test as cli_test
    from miseg_tpu_torch.train.checkpoint import (checkpoint_format,
                                                  load_any_checkpoint_params, load_checkpoint)

    cfg = fit["cfg"]
    best = Path(cfg.default_root_dir) / "finetune" / "best.ckpt"
    ck = load_checkpoint(best)
    lightning = root / "epoch=1-step=8.ckpt"
    reference_ckpt(lightning, ck["params"], int(ck["epoch"]))
    check(checkpoint_format(lightning) == "torch" and checkpoint_format(best) == "port",
          "reference ckpt: the formats were not told apart")
    target = {n: torch.zeros_like(v) for n, v in ck["params"].items()}
    ours = load_any_checkpoint_params(best, target, model_name=cfg.model_name)
    theirs = load_any_checkpoint_params(lightning, target, model_name=cfg.model_name)
    check(all(torch.equal(ours[n], theirs[n]) for n in ours),
          "reference ckpt: its weights differ from best.ckpt's")
    t0 = time.perf_counter()
    want = cli_test.main(cfg.replace(ckpt_path=str(best)), device=dev)
    got = cli_test.main(cfg.replace(ckpt_path=str(lightning)), device=dev)
    test_s = time.perf_counter() - t0
    gap = max(abs(got[k] - want[k]) for k in want if math.isfinite(want[k]))
    check(same_metrics(got, want), f"reference ckpt: cli.test metrics differ by up to {gap:.3e}")
    print(f"  reference .ckpt (Lightning, reference naming, {len(torch.load(lightning, weights_only=False)['state_dict'])} "
          f"entries): weights bitwise those of best.ckpt; cli.test on both: {len(got)} metrics, "
          f"max |diff| {gap:.3e}, exactly equal: {got == want} ({test_s:.2f} s)")


def host_stitching(dev, fit: dict, size: int = 224) -> None:
    """(6) A `size`^3 flagship volume through the fine-tuned weights with
    `infer_cpu` (host stitching) and without: within 1e-5 of each other;
    the device's peak memory lower with `infer_cpu`; windows/s of both."""
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.train.engine import Trainer

    cfg = fit["cfg"]
    weights = fit["trainer"].state_dict(fit["state"])
    gen = torch.Generator().manual_seed(12)
    image, _ = synthetic_case(size, cfg.out_channels, gen)
    image = image.to(dev)
    mods = torch.tensor([1], dtype=torch.int32, device=dev)
    windows = len(window_starts((size,) * 3, cfg.roi, cfg.infer_overlap)[1])
    out, peak, took = {}, {}, {}
    for host in (False, True):
        trainer = Trainer(cfg.replace(infer_cpu=host), device=dev)
        trainer.init_state(weights)
        inferer = trainer.make_inferer()
        inferer(image[:, :cfg.roi_x, :cfg.roi_y, :cfg.roi_z], mods)   # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = inferer(image, mods)
        torch.cuda.synchronize()
        took[host] = time.perf_counter() - t0
        peak[host] = torch.cuda.max_memory_allocated() - base
        out[host] = logits.cpu()
        del trainer, inferer, logits
    err = max_err(out[True], out[False])
    check(out[True].shape == (1, size, size, size, cfg.out_channels) and err <= 1e-5,
          f"host stitching {size}^3: |host - device| {err:.3e} (tol 1e-5)")
    check(peak[True] < peak[False], f"host stitching {size}^3: device peak "
                                    f"{peak[True] / 2 ** 20:.1f} MiB not below {peak[False] / 2 ** 20:.1f}")
    print(f"  host stitching {size}^3 ({windows} windows, bf16): |host - device| {err:.2e} "
          f"(tol 1e-5); device peak above baseline {peak[False] / 2 ** 20:.1f} MiB device-"
          f"stitched, {peak[True] / 2 ** 20:.1f} MiB host-stitched; {took[False]:.3f} s "
          f"({windows / took[False]:.2f} windows/s) vs {took[True]:.3f} s "
          f"({windows / took[True]:.2f} windows/s)")


def batch_size_tuner(dev, peaks: dict) -> None:
    """(7) `scale_batch_size` with real trials of the flagship at 96^3
    under a per-process memory fraction set halfway between what batch 2
    and batch 4 need (from `recompute_memory`'s peaks): batch 4 must stop
    the doubling with a real `torch.cuda.OutOfMemoryError`, the result is
    2, and afterwards the card holds within 64 MiB of what it held."""
    import gc

    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train import tuner

    cfg = Config(**FLAGSHIP)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    act = peaks[2, False] - peaks[1, False]
    limit = torch.cuda.memory_reserved() + peaks[2, False] + act
    total = torch.cuda.get_device_properties(dev).total_memory
    trials = []

    def recorded(c, bs):
        try:
            tuner._try_batch(c, bs, dev)
        except torch.cuda.OutOfMemoryError:
            trials.append((bs, "OutOfMemoryError"))
            raise
        trials.append((bs, "fits"))

    index = torch.cuda.current_device()   # the call takes an index, not "cuda"
    torch.cuda.set_per_process_memory_fraction(limit / total, index)
    try:
        t0 = time.perf_counter()
        best = tuner.scale_batch_size(cfg, step_fn=recorded, verbose=False)
        took = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, index)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    check(best == 2 and trials == [(1, "fits"), (2, "fits"), (4, "OutOfMemoryError")],
          f"tuner: returned {best} after trials {trials} under a {limit / 2 ** 30:.2f} GiB limit")
    check(abs(after - before) <= 64 << 20,
          f"tuner: the card holds {(after - before) / 2 ** 20:.1f} MiB more than before")
    print(f"  batch-size tuner: limit {limit / 2 ** 30:.2f} GiB of {total / 2 ** 30:.1f}; trials "
          f"{trials} -> batch_size {best} ({took:.2f} s); allocated after - before "
          f"{(after - before) / 2 ** 20:.2f} MiB")


def lr_sweep(dev, fit: dict) -> None:
    """(8) `find_best_lr.main` for 12 steps on the fine-tune's config:
    losses finite until its own early stop, the suggestion inside
    [min_lr, max_lr], args.json and curve.json written."""
    from miseg_tpu_torch.cli import find_best_lr

    cfg = fit["cfg"]
    t0 = time.perf_counter()
    result = find_best_lr.main(cfg, device=dev, num_steps=12)
    took = time.perf_counter() - t0
    losses = result["losses"]
    out = Path(cfg.default_root_dir) / "lr_find"
    curve = json.load(open(out / "curve.json"))
    check(len(losses) >= 2 and all(math.isfinite(v) for v in losses[:-1]),
          f"lr sweep: losses {losses}")
    check(cfg.min_lr <= result["lr"] <= cfg.max_lr, f"lr sweep: suggestion {result['lr']}")
    check(curve == {"lrs": result["lrs"], "losses": losses}
          and json.load(open(out / "args.json"))["suggested_lr"] == result["lr"],
          "lr sweep: args.json / curve.json do not hold the sweep")
    print(f"  lr sweep: {len(losses)} steps from {result['lrs'][0]:.1e} to "
          f"{result['lrs'][-1]:.2e}, losses {' '.join(f'{v:.4f}' for v in losses)}; suggestion "
          f"{result['lr']:.3e} ({took:.2f} s)")


def phase_finetune(dev, card: str, shape=(192, 192, 160)) -> dict:
    """Fine-tuning the flagship from existing weights on the card, at full
    width: (1) a MONAI-layout Swin-ViT file from a seed, (2) `cli.train` of
    `pre_swin_unetr` with `--pre_swin` and `--use_checkpoint`
    (`finetune_fit`), (3) `recompute_card_vs_card`, (4) `recompute_memory`,
    (5) `reference_ckpt_test`, (6) `host_stitching`, (7)
    `batch_size_tuner`, (8) `lr_sweep`.  Returns the fit's launches."""
    from miseg_tpu_torch.config import Config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = fit_data(tmp, shape, 6)
        swin_path = Path(tmp) / "model_swinvit.pt"
        want = monai_swin_vit_file(swin_path, Config(**FINETUNE), seed=13)
        fit = finetune_fit(dev, card, root, swin_path, want)
        recompute_card_vs_card(dev)
        peaks = recompute_memory(dev)
        reference_ckpt_test(dev, fit, Path(tmp))
        host_stitching(dev, fit)
        batch_size_tuner(dev, peaks)
        lr_sweep(dev, fit)
    print(f"finetune: pre_swin_unetr fine-tuned from a MONAI Swin-ViT file with recompute, "
          f"every kernel launching in the forward and again in the backward "
          f"({RECOMPUTE_PER_STEP}); a reference .ckpt tested alike; host stitching, the "
          f"batch-size tuner and the lr sweep on the card ({time.perf_counter() - t_phase:.1f} s)")
    return {"train": fit["train"], "eval": fit["eval"], "step_ms": fit["step_ms"]}


# the (feature_size, heads) pairs of the hyper-parameter search's swin
# widths (12/24/36 x 2/3/4: miseg_tpu_torch/cli/tune.py `set_trial_config`,
# as the JAX package's and the reference's) that `tune_windows` holds card
# vs CPU: one a width, each head count once (head dims 3, 8 and 18; the
# heads change no K4 shape, and K5 runs at head dims 3, 9 and 18 in
# `tune_kernels`).  All 9 pairs took ~55 s of the phase.
SEARCH_PAIRS = ((12, 4), (24, 3), (36, 2))
# K4 at the search space's conv shapes whose channels (12, 24, 36, 72) are
# no multiple of 16, which the tensor-core kernels pad to 16 in shared
# memory, with the decoder's mixed widths (the concatenation before
# decoder1..3): (label, x shape, Cout, prologue, bf16 kernel)
SEARCH_CONVS = [
    ("fs12 encoder1/decoder1 conv2", (1, 96, 96, 96, 12), 12, True, "miseg_k4_conv_brick"),
    ("fs36 encoder1/decoder1 conv2", (1, 96, 96, 96, 36), 36, True, "miseg_k4_conv_brick"),
    ("fs12 encoder1 conv1 (Cin = 1)", (1, 96, 96, 96, 1), 12, False, "miseg_k4_conv_cin1"),
    ("fs24 encoder2/decoder2 conv2", (1, 48, 48, 48, 24), 24, True, "miseg_k4_conv_brick"),
    ("fs36 encoder3/decoder3 conv2", (1, 24, 24, 24, 72), 72, True, "miseg_k4_conv_coarse"),
    ("fs12 decoder1 conv1", (1, 96, 96, 96, 24), 12, False, "miseg_k4_conv_brick"),
    ("fs24 decoder1 conv1", (1, 96, 96, 96, 48), 24, False, "miseg_k4_conv_brick"),
    ("fs36 decoder1 conv1", (1, 96, 96, 96, 72), 36, False, "miseg_k4_conv_brick"),
    ("fs36 decoder3 conv1", (1, 24, 24, 24, 144), 72, False, "miseg_k4_conv_coarse"),
]
# K4's FMA kernel, which f32 takes at every width (never TF32), at the
# search space's and the flagship's widest 96^3 conv: (label, x shape,
# Cout, prologue); `F.conv3d` beside it runs in f32 with TF32 off
FMA_F32_CONVS = [
    ("f32 fs12 encoder1/decoder1 conv2", (1, 96, 96, 96, 12), 12, True),
    ("f32 fs48 encoder1/decoder1 conv2", (1, 96, 96, 96, 48), 48, True),
]
# K5 at stage 1 of a 96^3 window at the search space's new head dims
# (fs / heads: 12/4 = 3, 36/4 = 9, 36/2 = 18): (label, channels, heads)
SEARCH_ATTN = [("hd3 (fs12 h4)", 12, 4), ("hd9 (fs36 h4)", 36, 4), ("hd18 (fs36 h2)", 36, 2)]
# the device memory a trial may leave allocated: what a first trial makes
# once and keeps (on an NVIDIA H100 80GB HBM3: 32 MiB when the tune phase
# ran alone, 0 after the other phases; not traced)
TUNE_MEMORY_MARGIN = 64 << 20


def search_cfg(fs: int, heads: int, **kw):
    from miseg_tpu_torch.config import Config
    return Config(**{**FLAGSHIP, "feature_size": [fs], "num_heads": heads, **kw})


def tune_kernels(dev, card: str, mem_bw: float, bf16_flops: float) -> dict:
    """(b) K4 at `SEARCH_CONVS` (bf16, each on its tensor-core kernel by
    name) and `FMA_F32_CONVS` (f32, the FMA kernel) and K5 at `SEARCH_ATTN`
    against their plain versions in bf16 and f32, with times beside their
    bounds (K4 against `F.conv3d`, device time too; K5 against SDPA).
    Returns their timed rows by label."""
    gen = torch.Generator().manual_seed(21)
    rows = {"K4": {}, "K5": {}}
    convs = [(*c, torch.bfloat16) for c in SEARCH_CONVS]
    convs += [(*c, "miseg_k4_conv_fma", torch.float32) for c in FMA_F32_CONVS]
    for label, shape, cout, prologue, kernel, dtype in convs:
        line, row = k4_case(label, shape, cout, prologue, dev, gen, mem_bw, bf16_flops,
                            timed=dtype, kernel=kernel,
                            flops_peak=F32_PEAKS[card_key(card)] if dtype == torch.float32
                            else None)
        print(line)
        rows["K4"][label] = {"shape": [*shape[:-1], f"{shape[-1]}->{cout}"],
                             "dtype": str(dtype)[6:], **row}
    for label, c, heads in SEARCH_ATTN:
        line, row = k5_case(f"stage 1 {label}", 343, 343, c, heads, (49, 49, 49), dev, gen,
                            mem_bw, bf16_flops)
        print(line)
        rows["K5"][label] = {"shape": [343, 343, c], "heads": heads, **row}
    return rows


def tune_windows(dev, size: int = 64) -> dict:
    """(a) Each swin (feature_size, heads) pair of `SEARCH_PAIRS`, from one
    seed: a `size`^3 window of two samples (CT, MR) in f32
    on the card (every kernel launching, K4 on its FMA path: f32 never
    takes the tensor cores) against the CPU's plain versions
    (`check_card_logits`); then a bf16 96^3 window launching
    `PER_WINDOW` (the widths change no count), profiled under
    `window_faults` with `WINDOW_K4`: the padded widths run the
    flagship's K4 kernels (12 coarse, one Cin = 1, the rest brick), no
    FMA kernel or split-K reduce.  That window is a CPU-exported bundle's
    (served through its window graph) for the pair with heads 3, and the
    live bf16 model's for the other two: the heads change no K4 shape, and
    the exports took ~5 s each.  Returns, by pair, the K4
    kernels of a bf16 window by name and its device busy and K4 ms."""
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    k4_by_pair = {}
    for fs, heads in SEARCH_PAIRS:
        label = f"fs{fs} h{heads}"
        cfg = search_cfg(fs, heads, roi_x=size, roi_y=size, roi_z=size)
        cpu = model_from_config(cfg, device="cpu")
        gen = torch.Generator().manual_seed(22)
        x = torch.randn((2, size, size, size, 1), generator=gen)
        mods = torch.tensor([0, 1], dtype=torch.int32)
        with torch.inference_mode():
            want = cpu(x, mods)
        top2 = want.topk(2, dim=-1).values
        card = model_from_config(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        reset_launches()
        with torch.inference_mode():
            got = card(x.to(dev), mods.to(dev)).cpu()
        counts = launch_counts()
        check(all(n > 0 for n in counts.values()),
              f"search window {label}: a kernel did not launch: {counts}")
        words = check_card_logits(f"search window {label}", got, want,
                                  top2[..., 0] - top2[..., 1])
        del cpu, card
        # the bf16 window at 96^3: served from a bundle, or the live model
        cfg96 = search_cfg(fs, heads)
        window = torch.rand((1, 96, 96, 96, 1), generator=gen).to(dev)
        one = torch.tensor([1], dtype=torch.int32, device=dev)
        if heads == 3:
            with tempfile.TemporaryDirectory() as tmp:
                save_bundle(cfg96, model_from_config(cfg96, device=dev).state_dict(), tmp)
                served = load_bundle(tmp)
            served(window, [0])
            eager, run = (lambda: served.window_fn(window, one)), lambda: served(window, [1])
        else:
            served = model_from_config(cfg96, device=dev).to(torch.bfloat16)
            eager = run = lambda: served(window.to(torch.bfloat16), one)
        torch.cuda.synchronize()
        reset_launches()
        with torch.inference_mode():
            logits = eager()
            torch.cuda.synchronize()
            check(launch_counts() == PER_WINDOW and bool(torch.isfinite(logits).all()),
                  f"search window {label} bf16 96^3: launched {launch_counts()}, want "
                  f"{PER_WINDOW}, finite {bool(torch.isfinite(logits).all())}")
            events = profiled(run, lambda ev: not window_faults(ev, 1), lead=run)
        faults = window_faults(events, 1)
        if replay_counts(events) != PER_WINDOW:
            faults.append(f"the served window ran kernels by name {replay_counts(events)}")
        check(not faults, f"search window {label} bf16 96^3 profile: " + "; ".join(faults))
        k4 = {name: sum(name in e.name for e in events) for name in K4_KERNELS}
        k4 = {name.removeprefix("miseg_k4_"): n for name, n in k4.items() if n}
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        k4_ms = sum(e.time_range.elapsed_us() for e in events if "miseg_k4_" in e.name) / 1e3
        k4_by_pair[label] = {"kernels": k4, "busy_ms": busy, "k4_ms": k4_ms}
        print(f"  search window {label}: {size}^3 f32 card vs CPU {words}; bf16 96^3 "
              f"window launches {PER_WINDOW}, K4 kernels {k4}, device busy {busy:.2f} ms "
              f"(K4 {k4_ms:.2f})")
        del served
    return k4_by_pair


def asha_decisions(records: list[dict], min_resource: int, rf: int = 3) -> list[tuple]:
    """Successive halving's decisions rebuilt from a study journal's
    reports as they arrived: (trial, step, its best value at the rung, the
    rung's cutoff, pruned) for every report the pruner ranks (the rule of
    `hpo.pruners.SuccessiveHalvingPruner`)."""
    inter: dict[int, dict[int, float]] = {}
    out = []
    for r in records:
        if r["op"] != "report":
            continue
        inter.setdefault(r["trial"], {})[r["step"]] = r["value"]
        if r["step"] + 1 < min_resource:
            continue
        rung = 0
        while min_resource * rf ** (rung + 1) <= r["step"] + 1:
            rung += 1
        resource = min_resource * rf ** rung
        best = {t: max(v for s, v in iv.items() if s + 1 <= resource)
                for t, iv in inter.items() if any(s + 1 <= resource for s in iv)}
        if len(best) < rf:
            continue
        cutoff = sorted(best.values(), reverse=True)[math.ceil(len(best) / rf) - 1]
        out.append((r["trial"], r["step"], best[r["trial"]], cutoff,
                    best[r["trial"]] < cutoff))
    return out


def tune_study(dev, card: str, shape=(192, 192, 160)) -> dict:
    """(c) `cli.tune.main` on the card: the flagship's norms, 6 classes,
    96^3 ROI, bf16, warmup_cosine, 4 epochs with a validation each (the
    pruner's first rung at epoch index 3), 2 trials, then 1 more resumed
    from the journal, on `phase_fit`'s synthetic set (written once).
    Checks each trial's params.json against the journal, the widths it
    ran (its model's parameter count), every kernel launching, device
    memory back at the study's baseline after each trial, the dashboard's
    report, and the states against the pruner's rule rebuilt from the
    journal.  Returns the study's launches."""
    from miseg_tpu_torch import hpo
    from miseg_tpu_torch.cli import dashboard
    from miseg_tpu_torch.cli import tune
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.train import engine

    trials, told = [], []
    fit, tell = engine.Trainer.fit, hpo.Study.tell

    def recorded_fit(self, data, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            return fit(self, data, **kw)
        finally:
            torch.cuda.synchronize()
            trials.append(dict(
                fs=self.cfg.feature_size_scalar, heads=self.cfg.num_heads,
                n_params=sum(p.numel() for p in self.model.parameters()),
                history={k: list(v) for k, v in self.history.items()},
                fit_s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(),
                launches={k: n - before[k] for k, n in launch_counts().items()}))

    def recorded_tell(self, trial, value, state="complete"):
        torch.cuda.synchronize()
        told.append(dict(number=trial.number, state=state, value=value,
                         allocated=torch.cuda.memory_allocated()))
        return tell(self, trial, value, state)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = fit_data(tmp, shape, 6)
        cfg = search_cfg(48, 3, data_dirs=[str(root)] * 2, json_lists=["CT.json", "MR.json"],
                         max_epochs=4, check_val_every_n_epoch=1, scheduler="warmup_cosine",
                         batch_size=1, patches_training_sample=1, num_workers=2, cache_num=8,
                         n_trials=2, default_root_dir=str(Path(tmp) / "runs"),
                         study_name="swin_search", seed=0)
        torch.cuda.synchronize()
        baseline = torch.cuda.memory_allocated()
        engine.Trainer.fit, hpo.Study.tell = recorded_fit, recorded_tell
        reset_launches()
        try:
            t0 = time.perf_counter()
            tune.main(cfg, device=dev)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            study = tune.main(cfg.replace(n_trials=1), device=dev)
            resume_s = time.perf_counter() - t0
        finally:
            engine.Trainer.fit, hpo.Study.tell = fit, tell
        launches = launch_counts()
        storage = Path(cfg.default_root_dir) / f"{cfg.storage_name}.journal.jsonl"
        records = [json.loads(line) for line in open(storage)]
        report = dashboard.study_report(str(storage), cfg.study_name)
        params = {}
        for r in records:
            if r["op"] == "param":
                params.setdefault(r["trial"], {})[r["name"]] = r["value"]
        on_disk = {n: json.loads((Path(cfg.default_root_dir) / cfg.study_name / str(n)
                                  / "params.json").read_text()) for n in params}

    # ---- the study, its journal, the dashboard -----------------------------
    check(len(study.trials) == 3 and len(trials) == 3 and len(told) == 3
          and sum(r["op"] == "create" for r in records) == 3
          and sum(r["op"] == "study" for r in records) == 1,
          f"tune: {len(study.trials)} trials in the resumed study, {len(trials)} fits, "
          f"{len(told)} told, journal {[r['op'] for r in records if r['op'] != 'report']}")
    check(on_disk == params == {t.number: t.params for t in study.trials},
          f"tune: params.json {on_disk} against the journal's {params}")
    for t, rec in zip(study.trials, trials):
        want = sum(p.numel() for p in model_from_config(
            search_cfg(t.params["feature_size"], t.params["num_heads"]),
            device="meta").parameters())
        check((rec["fs"], rec["heads"], rec["n_params"])
              == (t.params["feature_size"], t.params["num_heads"], want),
              f"tune trial {t.number}: ran fs {rec['fs']} heads {rec['heads']} with "
              f"{rec['n_params']} parameters; sampled {t.params}, whose model has {want}")
    check(all(n > 0 for n in launches.values()), f"tune: a kernel never launched: {launches}")
    leaks = [t["allocated"] - baseline for t in told]
    check(all(d <= TUNE_MEMORY_MARGIN for d in leaks),
          f"tune: device memory after each trial minus the baseline {leaks} B > "
          f"{TUNE_MEMORY_MARGIN} B")
    best = study.best_trial
    check(report["n_trials"] == 3 and report["best"] == {
        "number": best.number, "value": best.value, "params": best.params},
          f"tune: the dashboard reports {report['n_trials']} trials, best {report['best']}; "
          f"the study's best is #{best.number}")
    states = [t.state for t in study.trials]
    check(set(states) <= {"complete", "pruned"}, f"tune: states {states}")
    decisions = asha_decisions(records, min_resource=4 * cfg.check_val_every_n_epoch)
    pruned = {n for n, _, _, _, p in decisions if p}
    check(pruned == {t.number for t in study.trials if t.state == "pruned"},
          f"tune: the pruner's rule prunes {sorted(pruned)}, the study pruned "
          f"{[t.number for t in study.trials if t.state == 'pruned']}")
    for t, rec, tl in zip(study.trials, trials, told):
        h = rec["history"]
        print(f"  trial {t.number}: fs {t.params['feature_size']} heads "
              f"{t.params['num_heads']} lr {t.params['lr']:.3e} reg_weight "
              f"{t.params['reg_weight']:.3e} warmup_epochs {t.params['warmup_epochs']}; "
              f"{rec['n_params']} parameters; best Dice {max(t.intermediate.values()):.4f}, "
              f"{t.state}; {rec['fit_s']:.2f} s (set-up {sum(h['setup_s']):.2f}, steps "
              f"{sum(h['epoch_s']):.2f}, validations {sum(h['val_s']):.2f}, checkpoint saves "
              f"{sum(h['ckpt_s']):.2f}); step {statistics.median(h['step_ms'][1:]):.2f} ms p50 "
              f"({len(h['step_ms'])} steps); peak {rec['peak'] / 2 ** 30:.2f} GiB; after it "
              f"{(tl['allocated'] - baseline) / 2 ** 20:+.2f} MiB against the baseline; "
              f"launches {rec['launches']}")
    print("  pruner (rung 0 at epoch index 3): " + "; ".join(
        f"trial {n} step {s}: best {v:.4f} vs cutoff {c:.4f} -> "
        f"{'pruned' if p else 'kept'}" for n, s, v, c, p in decisions))
    print(f"tune: cli.tune ran 2 trials in {first_s:.1f} s and resumed 1 more in "
          f"{resume_s:.1f} s on '{card}' (states {states}, values "
          f"{[round(t.value, 4) for t in study.trials]}, best #{best.number}); "
          f"journal, params.json and the dashboard agree; device memory back within "
          f"{max(leaks) / 2 ** 20:.2f} MiB of the baseline after every trial; launches "
          f"{launches} ({time.perf_counter() - t_phase:.1f} s)")
    return launches


def phase_tune(dev, card: str, mem_bw: float, bf16_flops: float) -> dict:
    """The hyper-parameter search on the card: (a) `tune_windows`, (b)
    `tune_kernels`, (c) `tune_study`.  Returns the K4/K5 rows at the new
    shapes, the bf16 windows' K4 kernels and the study's launches."""
    t0 = time.perf_counter()
    k4_by_pair = tune_windows(dev)
    rows = tune_kernels(dev, card, mem_bw, bf16_flops)
    launches = tune_study(dev, card)
    print(f"tune phase: a pair a width of the search space matches the CPU through the "
          f"kernels, their "
          f"bf16 windows run K4 on the tensor cores, K4 at the search widths (bf16, tensor "
          f"cores; f32, FMA) and K5 at head dims 3/9/18 match their plain versions, and a 2 + 1 "
          f"trial study ran on the card ({time.perf_counter() - t0:.1f} s)")
    return {"rows": rows, "k4_by_pair": k4_by_pair, "study": launches}


# The 2-D flagship: C-Swin-UNETR at full width on 96x96 slices (the
# Config's roi_x, roi_y under spatial_dims=2).  Every conv is cuDNN's 2-D
# conv (K4 is 3-D only, as the JAX package's Pallas conv), so each of the
# 26 norms of the 10 UnetResBlocks (norm1 and norm2, and norm3 in the 6
# with a projected residual) is one K1 run and one K2 launch (its add and
# leaky relu in K2), as are the backbone's 25 (16 swin-block, 4 merging,
# 5 proj_out); one K5 launch a swin block on 7x7 windows (N = 49 at
# stage 1): no K3, no K4 and so no fold.
TWO_D = {**FLAGSHIP, "spatial_dims": 2}
TWO_D_PER_WINDOW = {"K1": 51, "K2": 51, "K3": 0, "K4": 0, "K5": 8, "K1 fold": 0}
CUNET_2D = {**CUNET, "spatial_dims": 2}
TWO_D_SLICE = (512, 512)   # the request: one slice of a 512x512 CT
# the batch-norm UNetVanilla of the two-rank check: the README recipe
VANILLA_BN = {**VANILLA, "encoder_norm_name": "batch", "decoder_norm_name": "batch",
              "no_amp": True}
DDP_STEPS = 3
# phase_ddp (c): the volume the two gloo ranks' `make_inferer` fans out
FANOUT_VOLUME = (192, 192, 160)
DDP_WARMUP = 2   # steps from the same start before the timed ones, in each trainer
DDP_TIMEOUT_S = 420
# the mesh phase: (a) the flagship's model at reduced width (fs 24, 64^3)
# in f32 under FSDP on "data" and tensor parallelism (alone and with FSDP
# of the unclaimed leaves) on "model"; (b) the flagship in bf16 under FSDP
MESH_SMALL = {**FLAGSHIP, "feature_size": [24], "roi_x": 64, "roi_y": 64, "roi_z": 64,
              "no_amp": True}
MESH_1X2 = dict(mesh_shape=[1, 2], mesh_axes=["data", "model"])
MESH_CASES = {"fsdp [2]": dict(fsdp=True),
              "tp [1, 2]": dict(MESH_1X2, tensor_parallel=True),
              "tp + fsdp [1, 2]": dict(MESH_1X2, tensor_parallel=True, fsdp=True,
                                       fsdp_axis="model")}
MESH_STEPS = 3   # flagship bf16 steps under FSDP; the first is held to one process


def two_d_kernels(dev, mem_bw: float, bf16_flops: float) -> dict:
    """(a) K5 at the 2-D shapes (stage 1: 49 windows of 7x7, N = 49, C 48,
    3 heads of 16, with and without the shifted window's region ids;
    stage 4: one 6x6 window clipped from 7x7, N = 36, C 384, 24 heads),
    and K1, K2 and K3 at the encoder's `[1, 96^2, 48]` (K3 is off the 2-D
    path: its blocks run K1 + K2), against their plain versions with
    times, as `phase_kernels`.  Returns the bf16 rows."""
    gen = torch.Generator().manual_seed(41)
    flush = l2_flush(dev)
    rows, lines = {}, []
    line, rows["K5"] = k5_case("2-D stage 1 (7x7)", 49, 49, 48, 3, (49, 49), dev, gen,
                               mem_bw, bf16_flops, window=(7, 7), device=True)
    lines.append(line)
    line, rows["K5 stage 4"] = k5_case("2-D stage 4 (6x6 of 7x7)", 1, 36, 384, 24, None,
                                       dev, gen, mem_bw, bf16_flops, window=(7, 7),
                                       device=True)
    lines.append(line)
    shape = (1, 96 * 96, 48)
    line, rows["K1"] = k1_case(shape, dev, gen, mem_bw, flush)
    lines.append(line)
    line, rows["K2"], _ = k2_case(shape, dev, gen, mem_bw, flush)
    lines.append(line)
    line, rows["K3"] = k3_case(shape, dev, gen, mem_bw, flush,
                               note=" (off the 2-D path)")
    lines.append(line)
    print("\n".join(lines))
    return rows


def two_d_card_vs_cpu(dev) -> None:
    """(b) One f32 forward of the 2-D C-Swin-UNETR and of the 2-D C-UNet
    at full width, a 96x96 slice, batch 2, card against CPU on the same
    seeded weights (`check_card_logits`; the Swin-UNETR within 1e-4 of the
    logits' scale, `phase_model`'s bound for the 3-D flagship), each
    launching its per-window counts (one call)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.models import model_from_config

    gen = torch.Generator().manual_seed(42)
    x = torch.randn((2, 96, 96, 1), generator=gen)
    mods = torch.tensor([0, 1], dtype=torch.int32)
    for label, model, per, rtol in (("2-D C-Swin-UNETR", TWO_D, TWO_D_PER_WINDOW, 1e-4),
                                    ("2-D C-UNet", CUNET_2D, CUNET_PER_WINDOW, None)):
        cfg = Config(**model)
        check(cfg.roi == (96, 96), f"{label}: roi {cfg.roi}")
        cpu = model_from_config(cfg, device="cpu")
        card = model_from_config(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        with torch.inference_mode():
            want = cpu(x, mods)
            reset_launches()
            got = card(x.to(dev), mods.to(dev)).cpu()
            counts = launch_counts()
        check(counts == per, f"{label}: launched {counts}, want {per}")
        top2 = want.topk(2, dim=-1).values
        tol = None if rtol is None else rtol * (1.0 + float(want.abs().max()))
        words = check_card_logits(label, got, want, top2[..., 0] - top2[..., 1], tol)
        print(f"  {label} fs{cfg.feature_size_scalar} 96x96 batch 2 f32 (TF32 off), card vs "
              f"CPU: {words}; launches {counts}")
        del cpu, card


def two_d_serve(dev, card: str) -> dict:
    """(c) The 2-D flagship exported as a bf16 bundle (seeded weights,
    gaussian blend, overlap 0.5) and a 512x512 slice from a seed served
    on the card: eagerly (the generic inferer over the window program; the
    launch counters rise by `TWO_D_PER_WINDOW` x windows), then through
    `predict` (the window graph, replayed once a window, nothing launched
    from Python), whose answer lies within the repeat tolerance of the
    eager one; a replayed window must run `TWO_D_PER_WINDOW` by name
    (`window_graph_kernels`), and the profiled whole request no K3 or K4
    and only the tensor-core `miseg_k5_attn_mma` as K5.  Prints ms a
    window, windows/s and the request's busy time.  Returns the launches
    of the eager request."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import SlidingWindowInferer, window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    cfg = Config(**TWO_D)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_bundle(cfg, model_from_config(cfg, device="cpu").state_dict(), tmp)
        export_s = time.perf_counter() - t0
        served = load_bundle(tmp)
    check(served.compute_dtype == torch.bfloat16, "2-D serve: bundle is not bf16")
    vol = torch.rand((1, *TWO_D_SLICE, 1), generator=torch.Generator().manual_seed(43))
    windows = len(window_starts(TWO_D_SLICE, cfg.roi, cfg.infer_overlap)[1])
    eager = SlidingWindowInferer(served.window_fn, cfg.roi, cfg.sw_batch_size,
                                 cfg.infer_overlap, "gaussian", out_channels=cfg.out_channels,
                                 device=dev)
    mods = torch.tensor([0], dtype=torch.int32)
    eager(vol, mods)   # warm-up: the per-shape plans and caches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    want = eager(vol, mods)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    counts = launch_counts()
    expect = {k: v * windows for k, v in TWO_D_PER_WINDOW.items()}
    check(counts == expect, f"2-D serve eager: launched {counts}, want {expect}")
    with torch.inference_mode():
        served.predict(vol, [0])   # warm-up and the window graph's capture
    took = []
    for _ in range(3):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = served.predict(vol, [0])
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
        check(launch_counts() == dict.fromkeys(PER_WINDOW, 0),
              f"2-D serve predict: launched {launch_counts()} from Python")
    check(tuple(got.shape) == (1, *TWO_D_SLICE, cfg.out_channels),
          f"2-D serve: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "2-D serve: non-finite logits")
    rep, rep_tol = max_err(got, want), 1e-3 * (1.0 + float(want.abs().max()))
    check(rep <= rep_tol, f"2-D serve: the window graph's answer differs from eager by "
                          f"{rep:.3e} > {rep_tol:.3e}")
    walls = []

    def run():
        t0 = time.perf_counter()
        with torch.inference_mode():
            served.predict(vol, [0])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    replayed = window_graph_kernels(served, vol, 0, TWO_D_PER_WINDOW, windows)
    check(replayed == expect, f"2-D serve predict: kernels by name {replayed}, want {expect}")
    # the whole request, for its busy time: the profiler may drop a few of
    # its ~15,000 kernels (as `window_graph_kernels` says), so its counts are
    # printed, and held only to run no K3, no K4 and only the tensor-core K5
    events = profiled(run, lambda ev: replay_counts(ev) == expect)
    by_name = replay_counts(events)
    k5_names = sorted({e.name for e in events if "miseg_k5_" in e.name
                       or "window_attention" in e.name})
    check(by_name["K3"] == by_name["K4"] == by_name["K1 fold"] == 0 and by_name["K5"] > 0,
          f"2-D serve predict: kernels by name {by_name}")
    check(all("miseg_k5_attn_mma" in n for n in k5_names), f"2-D serve: K5 kernels {k5_names}")
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    _, groups = kernel_groups(events, windows)
    med = statistics.median(took)
    print(f"  2-D serve: bundle exported on the CPU in {export_s:.1f} s; a "
          f"{TWO_D_SLICE[0]}x{TWO_D_SLICE[1]} slice, {windows} windows of 96x96, gaussian, "
          f"overlap 0.5, bf16 on '{card}': eager {eager_s:.3f} s; predict (window graph) "
          f"{med * 1e3:.2f} ms median of {len(took)} ({med * 1e3 / windows:.3f} ms a window, "
          f"{windows / med:.1f} windows/s); against eager max |diff| {rep:.3e} (tol "
          f"{rep_tol:.3e}); a replayed window's kernels by name x replays {replayed} (= "
          f"TWO_D_PER_WINDOW x {windows}); the profiled request: kernels by name {by_name}, "
          f"K5 {k5_names[0][:60]}, {walls[-1]:.2f} ms wall, {busy:.2f} ms device busy (idle "
          f"share {max(0.0, 1 - busy / walls[-1]):.1%})")
    print("    by group ms a window: " + ", ".join(
        f"{g} {ms:.4f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    del served
    return counts


def phase_two_d(dev, card: str, mem_bw: float, bf16_flops: float) -> dict:
    """2-D models on the card (`spatial_dims=2`): (a) `two_d_kernels`, (b)
    `two_d_card_vs_cpu`, (c) `two_d_serve`, (d) one f32 AdamW step of the
    2-D flagship, 96x96, batch 2, card against CPU (`train_card_vs_cpu`,
    the 3-D check's bounds), and its full-width bf16 step (`train_full`:
    `TWO_D_PER_WINDOW` launched by one step's forward, every gradient
    finite and non-zero, a falling loss, a profile with no K4).  Returns
    the bf16 rows, the serve and step launches."""
    t0 = time.perf_counter()
    rows = two_d_kernels(dev, mem_bw, bf16_flops)
    two_d_card_vs_cpu(dev)
    serve = two_d_serve(dev, card)
    train_card_vs_cpu(dev, size=96, model=TWO_D, dims=2, batch_size=2)
    step = train_full(dev, card, warmup=2, steps=5, model=TWO_D, per=TWO_D_PER_WINDOW,
                      k4=UNET_WINDOW_K4)
    print(f"two_d: the 2-D C-Swin-UNETR and C-UNet match the CPU; the 2-D bundle serves a "
          f"{TWO_D_SLICE[0]}x{TWO_D_SLICE[1]} slice through K1, K2 and K5 at N = 49 (no K4); "
          f"the 2-D step matches the CPU and trains in bf16 "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"rows": rows, "serve": serve, "step": step}


# the pipeline phase: GPipe over gloo ranks sharing the card, batch 2 in two
# microbatches; the flagship's four swin stages on [1, 4], C-UNETR's twelve
# ViT blocks on [1, 2]
PP_SWIN = dict(mesh_shape=[1, 4], mesh_axes=["data", "pp"], pipeline_parallel=True,
               pp_microbatches=2)
PP_UNETR = {**PP_SWIN, "mesh_shape": [1, 2]}
PP_UNETR_SMALL = {**UNETR, "roi_x": 64, "roi_y": 64, "roi_z": 64, "no_amp": True}
# (world, mesh fields, the f32 model, the full-width bf16 model) of each leg
PP_LEGS = {"pp4": (4, PP_SWIN, MESH_SMALL, FLAGSHIP), "pp2": (2, PP_UNETR, PP_UNETR_SMALL, UNETR)}
# GPipe beside FSDP and tensor parallelism, in the "pp4" leg's ranks: (d)
# one f32 step of each case (its mesh fields, its f32 model: the flagship's
# model at fs 24, or C-UNETR at its own width); (e) the flagship in bf16 on
# [1, 4] with FSDP on the pipeline line, `PP_FSDP_STEPS` steps
# Spatial partitioning beside the pipeline and tensor parallelism, on a
# ("data", "sp", "pp" / "model") mesh [1, 2, 2]
SP_PP = {**PP_UNETR, "mesh_shape": [1, 2, 2], "mesh_axes": ["data", "sp", "pp"],
         "spatial_shard": True}
SP_TP = dict(mesh_shape=[1, 2, 2], mesh_axes=["data", "sp", "model"], spatial_shard=True,
             tensor_parallel=True)
PP_MESH_CASES = {
    "pp + fsdp on data [2, 2]": ({**PP_UNETR, "mesh_shape": [2, 2], "pp_microbatches": 1,
                                  "fsdp": True}, PP_UNETR_SMALL),
    "pp + fsdp on pp [1, 4]": ({**PP_SWIN, "fsdp": True, "fsdp_axis": "pp"}, MESH_SMALL),
    "pp x tp + fsdp [1, 2, 2]": ({**PP_UNETR, "mesh_shape": [1, 2, 2],
                                  "mesh_axes": ["data", "model", "pp"], "tensor_parallel": True,
                                  "fsdp": True, "fsdp_axis": "model"}, PP_UNETR_SMALL),
    "sp x pp [1, 2, 2]": (SP_PP, PP_UNETR_SMALL),
    "sp x tp [1, 2, 2]": (SP_TP, MESH_SMALL),
    "sp x tp + fsdp on model [1, 2, 2]": ({**SP_TP, "fsdp": True, "fsdp_axis": "model"},
                                          MESH_SMALL),
    "data x sp x model copies [1, 2, 2]": ({**SP_TP, "tensor_parallel": False},
                                           PP_UNETR_SMALL),
    "tp over data x sp [2, 2]": (dict(mesh_shape=[2, 2], mesh_axes=["data", "sp"],
                                      spatial_shard=True, tensor_parallel=True,
                                      tp_axis="data"), MESH_SMALL)}
PP_FSDP = {**PP_SWIN, "fsdp": True, "fsdp_axis": "pp"}
PP_FSDP_STEPS = 2
# (f) the full-width bf16 models beside them in the "pp4" ranks, `MESH_STEPS`
# steps each at batch 2: (model, mesh fields)
SP_BESIDE = {"C-UNETR sp x pp [1, 2, 2]": ("unetr", SP_PP),
             "flagship sp x tp [1, 2, 2]": ("flagship", SP_TP)}
# a microbatch through one flagship swin stage (depth 2): two blocks of two
# norms (one K1 run and one K2 launch each) and one K5, and patch merging's
# norm; through one C-UNETR ViT block: two norms
SWIN_STAGE = {"K1": 5, "K2": 5, "K5": 2}
VIT_BLOCK = {"K1": 2, "K2": 2}


def pp_launches(model: dict, stages: int, microbatches: int,
                window: dict | None = None) -> list[dict]:
    """The kernels each stage of a GPipe train step launches: its blocks
    once a microbatch, and on the last stage the rest of the model's window
    (the patch embedding launches none; `proj_out`, the ViT's final norm
    and the conv encoders and decoders run on the whole batch); the
    backward launches none.  `window`: the model's launches a step in one
    process, or under spatial partitioning a rank's (`sp_launches`: the
    ViT's blocks run whole, on every rank of a stage's spatial line)."""
    window, per = ((window or UNETR_PER_WINDOW,
                    {k: v * 12 // stages for k, v in VIT_BLOCK.items()})
                   if model["model_name"] == "unetr" else (window or PER_WINDOW, SWIN_STAGE))
    body = {k: microbatches * per.get(k, 0) for k in window}
    tail = {k: window[k] - stages * per.get(k, 0) for k in window}
    return [body] * (stages - 1) + [{k: body[k] + tail[k] for k in window}]


def _digest(tensors: dict) -> str:
    """A hash of tensors' names, dtypes and bytes (equal digests: bitwise
    equal tensors)."""
    h = hashlib.sha256()
    for n, t in sorted(tensors.items()):
        h.update(f"{n}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def pp_rank(dev, leg: str) -> dict:
    """A rank of `phase_pipeline`'s `leg`: (a) one f32 step of the leg's
    small model, and in "pp4" (d) one of each of `PP_MESH_CASES`; (b)
    `MESH_STEPS` bf16 steps of its full-width model, launches counted from
    0 before the first and read after the last, then one profiled step
    (every rank profiles one lead and one step: each step holds
    collectives), and in "pp4" (e) `pp_fsdp_steps` and (f)
    `sp_beside_steps`.  Rank 0 keeps the whole records, every rank the
    digests of its masters; each part's seconds."""
    from miseg_tpu_torch import parallel
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    _, par, small, big = PP_LEGS[leg]
    writer = parallel.is_writer()
    out = {"mesh": {}, "seconds": {}}
    t0 = time.perf_counter()
    trainer = Trainer(Config(**small, **par), device=dev)
    state, loss = trainer.train_step(trainer.init_state(), _mesh_batch(dev, small))
    out["small"] = _mesh_record(trainer, state, loss)
    out["small_digest"] = _digest(out["small"]["params"])
    del trainer, state
    for name, (mesh_par, model) in (PP_MESH_CASES.items() if leg == "pp4" else ()):
        trainer = Trainer(Config(**model, **mesh_par), device=dev)
        state, loss = trainer.train_step(trainer.init_state(),
                                         _share(_mesh_batch(dev, model)))
        rec = _mesh_record(trainer, state, loss)
        rec["digest"] = _digest(rec["params"])
        rec["line"] = trainer.mesh.line(trainer.cfg.pp_axis)
        if not writer:   # the whole tensors once, from rank 0
            rec["params"] = rec["grads"] = None
        out["mesh"][name] = rec
        del trainer, state
    out["seconds"]["f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = Trainer(Config(**big, **par), device=dev)
    state = trainer.init_state()
    batch = _mesh_batch(dev, big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, loss = trainer.train_step(state, batch)
    rec = _mesh_record(trainer, state, loss)
    losses, rec["ms"] = _stepped(trainer, state, batch, MESH_STEPS - 1)
    rec["launch_totals"] = launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["losses"] = [rec["loss"], *losses]
    rec["digest"] = _digest(rec["params"])
    rec["final_digest"] = _digest(state.params)
    events = profiled(lambda: trainer.train_step(state, batch), lambda ev: True, attempts=1,
                      lead=lambda: trainer.train_step(state, batch))
    rec["profiled"] = replay_counts(events)
    rec["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    rec["stage"] = trainer.mesh.index("pp")
    out["big"] = rec
    del trainer, state, events
    out["seconds"]["bf16"] = time.perf_counter() - t0
    if leg == "pp4":
        t0 = time.perf_counter()
        out["fsdp"] = pp_fsdp_steps(dev, big, batch)
        out["seconds"]["bf16 fsdp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["sp"] = sp_beside_steps(dev, {"flagship": batch})
        out["seconds"]["bf16 sp beside"] = time.perf_counter() - t0
    if not writer:   # the whole tensors once, from rank 0
        for r in (out["small"], rec, out.get("fsdp", {}), *out.get("sp", {}).values()):
            r["params"] = r["grads"] = None
    return out


def sp_beside_steps(dev, batches: dict) -> dict:
    """(f) of `SP_BESIDE`: `MESH_STEPS` bf16 steps of each full-width model
    on its mesh at batch 2 (`batches` by model, made where missing),
    launches (modes apart) counted from 0 before the first and read after
    the last, step ms by events, the peak from the first step, the bytes of
    masters and moments, the masters' digest after the first step and the
    last (gathered whole: every rank calls)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    out = {}
    for name, (kind, par) in SP_BESIDE.items():
        big = UNETR if kind == "unetr" else FLAGSHIP
        batch = batches.get(kind) or _mesh_batch(dev, big)
        torch.cuda.empty_cache()
        trainer = Trainer(Config(**big, **par), device=dev)
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state, loss = trainer.train_step(state, batch)
        rec = _mesh_record(trainer, state, loss)
        rec["grads"] = None   # the gates read the losses, the parameters and the digests
        losses, rec["ms"] = _stepped(trainer, state, batch, MESH_STEPS - 1)
        rec["launch_totals"] = {**launch_counts(), **mode_counts()}
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["losses"] = [rec["loss"], *losses]
        rec["digest"] = _digest(rec["params"])
        rec["final_digest"] = _digest(trainer.state_dict(state))
        rec["sp_top"] = trainer._sp_top
        rec["coords"] = dict(zip(trainer.mesh.axes, trainer.mesh.coords))
        out[name] = rec
        del trainer, state
    return out


def pp_fsdp_steps(dev, big: dict, batch: dict) -> dict:
    """(e) of `PP_MESH_CASES`: `PP_FSDP_STEPS` bf16 steps of the full-width
    `big` on [1, 4] with FSDP on the pipeline line, as `pp_rank`'s (b):
    launches counted from 0 before the first and read after the last, the
    peak from the first step on, one profiled step; the masters' digest
    after the first step and the last (gathered whole: every rank calls)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    trainer = Trainer(Config(**big, **PP_FSDP), device=dev)
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, loss = trainer.train_step(state, batch)
    rec = _mesh_record(trainer, state, loss)
    losses, rec["ms"] = _stepped(trainer, state, batch, PP_FSDP_STEPS - 1)
    rec["launch_totals"] = launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["losses"] = [rec["loss"], *losses]
    rec["digest"] = _digest(rec["params"])
    rec["final_digest"] = _digest(trainer.state_dict(state))
    events = profiled(lambda: trainer.train_step(state, batch), lambda ev: True, attempts=1,
                      lead=lambda: trainer.train_step(state, batch))
    rec["profiled"] = replay_counts(events)
    rec["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    rec["stage"] = trainer.mesh.index("pp")
    return rec


def _spawn_ranks(leg: str, world: int, root: Path) -> list[str]:
    """`world` rank processes of `leg` (`python3 chip_smoke.py _ddp_rank
    leg rank world rdzv out`), each held to `DDP_TIMEOUT_S`; any that
    fails or hangs fails the phase.  "nccl1" runs as a user starts it,
    under `torchrun --standalone --nproc_per_node=1`, and joins through
    `parallel.init_process_group`.  Each process leads its own session,
    killed whole if it outlives the timeout.  Returns their logs."""
    return _join_ranks(leg, _start_ranks(leg, world, root))


def _start_ranks(leg: str, world: int, root: Path) -> list:
    """`_spawn_ranks`' processes, started; `_join_ranks` waits for them."""
    rank_cmd = [str(Path(__file__).resolve()), "_ddp_rank", leg]
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={world}"] if leg == "nccl1" else [sys.executable])
    cmds = ([launch + rank_cmd + ["0", str(world), "-", str(root)]] if leg == "nccl1" else
            [launch + rank_cmd + [str(r), str(world), str(root / f"{leg}.rdzv"), str(root)]
             for r in range(world)])
    return [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, start_new_session=True) for cmd in cmds]


def _join_ranks(leg: str, procs: list) -> list[str]:
    """The logs of `_start_ranks`' processes, each held to `DDP_TIMEOUT_S`
    (killed whole past it); fails the phase unless every one exits 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, p in enumerate(procs):
        log = logs[r] if r < len(logs) else ""
        check(p.returncode == 0, f"ddp {leg}: rank {r} exited {p.returncode}:\n{log[-3000:]}")
    return logs


def _ddp_flagship_batch(dev):
    from miseg_tpu_torch.config import Config
    cfg = Config(**FLAGSHIP)
    image, label = synthetic_case(96, cfg.out_channels, torch.Generator().manual_seed(44))
    return cfg, {"image": image.to(dev), "label": label.to(dev),
                 "modality": torch.tensor([0], dtype=torch.int32, device=dev)}


def _vanilla_batch(dev):
    gen = torch.Generator().manual_seed(45)
    image = torch.randn((2, 96, 96, 96, 1), generator=gen)
    label = torch.randint(0, VANILLA["out_channels"], (2, 96, 96, 96), generator=gen)
    return {"image": image.to(dev), "label": label.to(dev),
            "modality": torch.tensor([0, 1], dtype=torch.int32, device=dev)}


def _stepped(trainer, state, batch, steps: int):
    """`steps` train steps; (losses, CUDA-event ms a step)."""
    losses, ms = [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = trainer.train_step(state, batch)
        end.record()
        end.synchronize()
        losses.append(float(loss))
        ms.append(start.elapsed_time(end))
    return losses, ms


def _mesh_batch(dev, model: dict, n: int = 2) -> dict:
    """A seeded global batch of `n` volumes (2-D models: slices) of
    `model`'s ROI (both modalities)."""
    gen = torch.Generator().manual_seed(46)
    cases = [synthetic_case(model["roi_x"], model["out_channels"], gen,
                            model.get("spatial_dims", 3)) for _ in range(n)]
    return {"image": torch.cat([c[0] for c in cases]).to(dev),
            "label": torch.cat([c[1] for c in cases]).to(dev),
            "modality": (torch.arange(n) % 2).to(torch.int32).to(dev)}


def _share(batch: dict) -> dict:
    """This rank's share of a global batch: its "data" coordinate's."""
    from miseg_tpu_torch import parallel
    shard, shards = parallel.host_shard_info()
    n = batch["image"].shape[0] // shards
    return {k: v[shard * n:(shard + 1) * n] for k, v in batch.items()}


def _mesh_record(trainer, state, loss) -> dict:
    """A step's loss, whole parameters and gradients (gathered), placements
    and this rank's bytes of masters and moments, on the host."""
    from miseg_tpu_torch.parallel import fsdp
    grads = fsdp.gather_full({n: p.grad for n, p in state.params.items()}, trainer.placements)
    kinds = [pl.kind for pl in trainer.placements.values()]
    sizes = {n: math.prod(s) for n, s in trainer._full_shapes.items()}
    return {"loss": float(loss), "buffers": {},
            "elements": sum(sizes.values()),
            "placed_elements": sum(sizes[n] for n in trainer.placements),
            "params": {n: t.detach().cpu().clone() for n, t in trainer.state_dict(state).items()},
            "grads": {n: g.cpu().clone() for n, g in grads.items()},
            "placed": {k: kinds.count(k) for k in ("fsdp", "tp")},
            "state_bytes": trainer.state_bytes(state)}


def mesh_rank(dev) -> dict:
    """The "mesh2" leg of a rank of `phase_mesh`: (a) one f32 step of
    `MESH_SMALL` under each of `MESH_CASES`; (b) `MESH_STEPS` bf16 steps
    of the flagship under FSDP `[2]` (launch counts, CUDA-event ms a step,
    one profiled step: both ranks profile exactly one lead and one step,
    since every step holds collectives)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    out = {}
    small = _mesh_batch(dev, MESH_SMALL)
    for name, par in MESH_CASES.items():
        trainer = Trainer(Config(**MESH_SMALL, **par), device=dev)
        state = trainer.init_state()
        state, loss = trainer.train_step(state, _share(small))
        out[name] = _mesh_record(trainer, state, loss)
        del trainer, state
    trainer = Trainer(Config(**FLAGSHIP, fsdp=True), device=dev)
    state = trainer.init_state()
    batch = _share(_mesh_batch(dev, FLAGSHIP))
    reset_launches()
    state, loss = trainer.train_step(state, batch)
    out["flagship"] = _mesh_record(trainer, state, loss)
    losses, ms = _stepped(trainer, state, batch, MESH_STEPS - 1)
    out["flagship"]["launch_totals"] = launch_counts()
    out["flagship"]["losses"] = [out["flagship"]["loss"], *losses]
    out["flagship"]["ms"] = ms
    events = profiled(lambda: trainer.train_step(state, batch), lambda ev: True, attempts=1,
                      lead=lambda: trainer.train_step(state, batch))
    out["flagship"]["profiled"] = replay_counts(events)
    out["flagship"]["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return out


def ddp_rank(leg: str, rank: int, world: int, rdzv: str, out: str) -> int:
    """One rank of `phase_ddp` (the `_ddp_rank` command line).  "nccl1",
    under `torchrun`: the flagship's bf16 steps unwrapped, then, after
    joining torchrun's one-rank NCCL group through
    `parallel.init_process_group` (what `cli.train` calls), the Trainer's
    data-parallel steps from the same start and a profiled one; "gloo2":
    one f32 step of the batch-norm UNetVanilla on this rank's half of the
    batch, the two ranks sharing the card over gloo (`rdzv`, a file);
    "mesh2": `mesh_rank`, over gloo the same way; "pp4", "pp2": `pp_rank`,
    and "sp2": `sp_rank`, over gloo the same way.  Writes `out/<leg>_rank<rank>.pt`."""
    import torch.distributed as dist

    from miseg_tpu_torch import parallel
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.parallel import mesh
    from miseg_tpu_torch.train.engine import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result: dict = {}
    if leg == "nccl1":
        cfg, batch = _ddp_flagship_batch(dev)
        plain = Trainer(cfg, device=dev)
        start = {n: t.detach().clone() for n, t in plain.state_dict(plain.init_state()).items()}
        _stepped(plain, plain.init_state(start), batch, DDP_WARMUP)
        state = plain.init_state(start)
        result["plain_losses"], result["plain_ms"] = _stepped(plain, state, batch, DDP_STEPS)
        result["plain_params"] = {n: p.detach().cpu() for n, p in state.params.items()}
        del plain, state
        check(dist.is_initialized() is False and os.environ.get("WORLD_SIZE") == "1",
              f"ddp nccl1: not a fresh torchrun rank (WORLD_SIZE {os.environ.get('WORLD_SIZE')})")
        joined = parallel.init_process_group()
        check(joined == dev and parallel.host_shard_info() == (0, 1)
              and dist.get_backend() == "nccl",
              f"ddp nccl1: torchrun's rank joined {joined}, {parallel.host_shard_info()}, "
              f"{dist.get_backend() if dist.is_initialized() else 'no group'}")
        wrapped = Trainer(cfg, device=joined)
        _stepped(wrapped, wrapped.init_state(start), batch, DDP_WARMUP)
        state = wrapped.init_state(start)
        reset_launches()
        result["wrapped_losses"], result["wrapped_ms"] = _stepped(wrapped, state, batch,
                                                                  DDP_STEPS)
        result["launches"] = {k: v // DDP_STEPS for k, v in launch_counts().items()}
        result["wrapped_params"] = {n: p.detach().cpu() for n, p in state.params.items()}
        grads = [p.grad for p in state.params.values() if p.grad is not None]
        result["buckets"] = len(list(mesh._buckets(
            [torch.zeros((), device=dev), *grads], mesh.BUCKET_BYTES)))
        events = profiled(lambda: wrapped.train_step(state, batch),
                          lambda ev: any("nccl" in e.name.lower() or "onerank" in e.name.lower()
                                         for e in ev),
                          lead=lambda: wrapped.train_step(state, batch))
        comm = [e for e in events if "nccl" in e.name.lower() or "onerank" in e.name.lower()]
        result["comm_kernels"] = sorted({e.name for e in comm})
        result["comm_launches"] = len(comm)
        result["comm_ms"] = sum(e.time_range.elapsed_us() for e in comm) / 1e3
        result["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    elif leg == "mesh2":
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world)
        result = mesh_rank(dev)
    elif leg in PP_LEGS:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world)
        result = pp_rank(dev, leg)
    elif leg == "sp2":
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world)
        result = sp_rank(dev)
    else:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world)
        trainer = Trainer(Config(**VANILLA_BN), device=dev)
        state = trainer.init_state()
        half = {k: v[rank:rank + 1] for k, v in _vanilla_batch(dev).items()}
        state, loss = trainer.train_step(state, half)
        result = {"loss": float(loss),
                  "params": {n: p.detach().cpu() for n, p in state.params.items()},
                  "grads": {n: p.grad.cpu() for n, p in state.params.items()},
                  "buffers": {n: b.cpu() for n, b in state.buffers.items()}}
        del trainer, state
        result["fanout"] = fanout_rank(dev, Path(out) if rank == 0 else None)
    dist.destroy_process_group()
    torch.save(result, Path(out) / f"{leg}_rank{rank}.pt")
    return 0


def _fanout_case(dev):
    """The flagship's Trainer (seeded weights) and the seeded volume and
    modality of phase_ddp (c)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    trainer = Trainer(Config(**FLAGSHIP), device=dev)
    trainer.init_state()
    gen = torch.Generator().manual_seed(47)
    volume = torch.randn((1, *FANOUT_VOLUME, 1), generator=gen).to(dev)
    return trainer, volume, torch.tensor([1], dtype=torch.int32, device=dev)


def fanout_rank(dev, out: Path | None) -> dict:
    """phase_ddp (c) on a rank: `make_inferer` of the flagship (96^3 ROI,
    bf16, constant blend) on `FANOUT_VOLUME`, its window groups fanned out
    over the two ranks; the launches counted from 0 just before and read
    just after, the windows it predicted, its logits' digest and seconds;
    with `out` the logits are saved there too."""
    t_part = time.perf_counter()
    trainer, volume, mod = _fanout_case(dev)
    inferer = trainer.make_inferer()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = inferer(volume, mod)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"launches": launch_counts(), "seconds": seconds,
           "part_s": time.perf_counter() - t_part,
           "windows": inferer.windows_predicted(FANOUT_VOLUME),
           "fanned": inferer._fan_out() is not None, "digest": _digest({"logits": logits})}
    if out is not None:
        torch.save(logits.cpu(), out / "fanout_logits.pt")
    return rec


def _w5_excess(got: dict, want: dict) -> float:
    """How far parameters exceed the W5 bound (rtol 1e-4 / atol 2.5e-4);
    <= 0 inside it."""
    return max(float(((g - want[n]).abs() - (2.5e-4 + 1e-4 * want[n].abs())).max())
               for n, g in got.items())


def check_ddp_step(got: dict, want: dict, where: str) -> dict:
    """A data-parallel step (`got`: the loss, params, grads and buffers of
    a rank) against one process's on the global batch (`want`): the loss
    within 1e-5, every gradient leaf within 5e-5 and their sum within
    1e-3, the parameters within the W5 bound, the running statistics
    (where the model has any) within rtol 1e-5 / atol 1e-6.  Fails the
    run otherwise; returns the gaps."""
    gaps = {n: max_err(g, want["grads"][n]) for n, g in got["grads"].items()}
    check(gaps.keys() == want["grads"].keys(), f"{where}: gradients of other leaves")
    worst = max(gaps, key=gaps.get)
    out = {"loss": abs(got["loss"] - want["loss"]), "worst": worst, "worst_gap": gaps[worst],
           "summed": sum(gaps.values()), "w5_excess": _w5_excess(got["params"], want["params"]),
           "stats": len(got["buffers"]),
           "stats_excess": max((float(((b - want["buffers"][n]).abs()
                                       - (1e-6 + 1e-5 * want["buffers"][n].abs())).max())
                                for n, b in got["buffers"].items()), default=0.0)}
    check(out["loss"] <= 1e-5, f"{where}: loss {got['loss']} vs {want['loss']}")
    check(out["worst_gap"] <= 5e-5 and out["summed"] <= 1e-3,
          f"{where}: gradient gap worst {worst} {out['worst_gap']:.3e}, summed "
          f"{out['summed']:.3e}")
    check(out["w5_excess"] <= 0.0,
          f"{where}: parameters exceed the W5 bound by {out['w5_excess']:.3e}")
    check(out["stats"] == len(want["buffers"]) and out["stats_excess"] <= 0.0,
          f"{where}: running statistics exceed rtol 1e-5 / atol 1e-6 by "
          f"{out['stats_excess']:.3e}")
    return out


def phase_ddp(dev, card: str) -> dict:
    """Data parallelism (`miseg_tpu_torch.parallel`), the ranks as
    subprocesses held to `DDP_TIMEOUT_S`: (a) one rank under `torchrun`,
    joined through `parallel.init_process_group` (NCCL at world size 1): three
    flagship steps (96^3, bf16) through the wrapped Trainer against the
    unwrapped one from the same start on the same batch, each after
    `DDP_WARMUP` steps of its own (losses within
    1e-3 relative, parameters within the W5 bound: the repeat tolerance of
    a bf16 step), the profiled wrapped step running NCCL's all-reduce
    kernels (one a gradient bucket), and the step times of both; (b) two
    gloo ranks sharing the card (NCCL takes one rank a device): one f32
    step of the batch-norm UNetVanilla at the README recipe, batch 1 a
    rank, against this process at batch 2: the loss within 1e-5, every
    gradient leaf within 5e-5 and their sum within 1e-3, the parameters
    within the W5 bound, the running statistics within rtol 1e-5 / atol
    1e-6, and the two ranks equal; (c) the same two ranks' `make_inferer`
    of the flagship on a 192 x 192 x 160 volume, its window groups fanned
    out over the ranks (`fanout_rank`): the logits bitwise equal to this
    process's inferer on the same volume (computed while the ranks run),
    each rank launching `PER_WINDOW` x its ceil(G/2) windows.  Returns
    the wrapped step's launches, and a rank's fan-out launches under
    "fanout"."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    _spawn_ranks("nccl1", 1, root)
    a = torch.load(root / "nccl1_rank0.pt", weights_only=False)
    loss_gap = max(abs(x - y) / (1 + abs(y))
                   for x, y in zip(a["wrapped_losses"], a["plain_losses"]))
    check(loss_gap <= 1e-3, f"ddp nccl1: wrapped losses {a['wrapped_losses']} vs "
                            f"{a['plain_losses']}")
    excess = _w5_excess(a["wrapped_params"], a["plain_params"])
    check(excess <= 0.0, f"ddp nccl1: parameters exceed the W5 bound by {excess:.3e}")
    check(a["comm_launches"] >= a["buckets"] > 0,
          f"ddp nccl1: {a['comm_launches']} NCCL kernels in the profiled step, want one a "
          f"bucket ({a['buckets']}); kernels {a['comm_kernels']}")
    check(a["launches"] == PER_WINDOW, f"ddp nccl1: a wrapped step launched {a['launches']}")
    p_ms, w_ms = statistics.median(a["plain_ms"]), statistics.median(a["wrapped_ms"])
    print(f"  ddp (a) torchrun, NCCL world 1, flagship 96^3 bf16 on '{card}': {DDP_STEPS} steps wrapped "
          f"vs unwrapped, losses {[round(v, 6) for v in a['wrapped_losses']]} vs "
          f"{[round(v, 6) for v in a['plain_losses']]} (max relative gap {loss_gap:.2e}), "
          f"parameters within the W5 bound (excess {excess:.2e}); step ms by events (median "
          f"of {DDP_STEPS} after {DDP_WARMUP} warm-up steps each) unwrapped {p_ms:.2f} "
          f"{[round(v, 2) for v in a['plain_ms']]}, wrapped {w_ms:.2f} "
          f"{[round(v, 2) for v in a['wrapped_ms']]}, difference {w_ms - p_ms:+.2f}; profiled wrapped step: {a['comm_launches']} NCCL kernels for "
          f"{a['buckets']} buckets, {a['comm_ms']:.3f} ms of {a['busy_ms']:.2f} ms device "
          f"busy; kernels {a['comm_kernels']}")

    t1 = time.perf_counter()
    procs = _start_ranks("gloo2", 2, root)
    trainer = Trainer(Config(**VANILLA_BN), device=dev)
    state = trainer.init_state()
    state, loss = trainer.train_step(state, _vanilla_batch(dev))
    want = {"loss": float(loss),
            "params": {n: p.detach().cpu() for n, p in state.params.items()},
            "grads": {n: p.grad.cpu() for n, p in state.params.items()},
            "buffers": {n: b.cpu() for n, b in state.buffers.items()}}
    del trainer, state
    # (c)'s reference: this process's inferer, no mesh, on the same volume
    trainer, volume, mod = _fanout_case(dev)
    inferer = trainer.make_inferer()
    check(inferer.mesh is None, "ddp (c): one process's inferer took a mesh")
    torch.cuda.synchronize()
    t0_one = time.perf_counter()
    one_logits = inferer(volume, mod)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0_one
    n_windows = inferer.windows_predicted(FANOUT_VOLUME)
    del trainer, inferer, volume
    _join_ranks("gloo2", procs)
    ranks = [torch.load(root / f"gloo2_rank{r}.pt", weights_only=False) for r in range(2)]
    for r, got in enumerate(ranks):
        gaps = check_ddp_step(got, want, f"ddp gloo2 rank {r}")
    for key in ("params", "buffers"):
        same = all(torch.equal(v, ranks[1][key][n]) for n, v in ranks[0][key].items())
        check(same, f"ddp gloo2: the ranks' {key} differ")
    print(f"  ddp (b) gloo, 2 ranks on one card, batch-norm UNetVanilla (README recipe) 96^3 "
          f"f32, batch 1 a rank vs one process at batch 2: loss |diff| {gaps['loss']:.2e}, "
          f"gradient gap summed {gaps['summed']:.3e} (worst {gaps['worst_gap']:.2e}), "
          f"parameters within the W5 bound (excess {gaps['w5_excess']:.2e}), "
          f"{gaps['stats']} running statistics within rtol 1e-5 / atol 1e-6; the ranks equal")
    fan = [res["fanout"] for res in ranks]
    rank_logits = torch.load(root / "fanout_logits.pt", weights_only=True)
    gap = max_err(rank_logits, one_logits.cpu())
    groups = n_windows   # sw_batch_size 1: a group a window
    per_rank = -(-groups // 2)
    want_launches = {k: v * per_rank for k, v in PER_WINDOW.items()}
    check(all(f["fanned"] for f in fan), "ddp (c): the ranks' inferer did not fan out")
    check(torch.equal(rank_logits, one_logits.cpu()) and fan[0]["digest"] == fan[1]["digest"]
          == _digest({"logits": one_logits}),
          f"ddp (c): fanned-out logits differ from one process's (max |diff| {gap:.3e}) or "
          "between the ranks")
    check(all(f["windows"] == per_rank and f["launches"] == want_launches for f in fan),
          f"ddp (c): the ranks predicted {[f['windows'] for f in fan]} windows and launched "
          f"{[f['launches'] for f in fan]}; want {per_rank} and {want_launches}")
    print(f"  ddp (c) gloo, 2 ranks on one card, flagship 96^3 bf16 make_inferer of a "
          f"{'x'.join(map(str, FANOUT_VOLUME))} volume ({groups} windows): each rank "
          f"predicted {per_rank} windows (ceil({groups}/2)), launches {fan[0]['launches']} a "
          f"rank = PER_WINDOW x {per_rank}; logits bitwise equal to this process's (max "
          f"|diff| {gap:.1e}) on both ranks; seconds a volume: ranks "
          f"{[round(f['seconds'], 3) for f in fan]}, one process {one_s:.3f} (all three "
          f"share the card); (c) {max(f['part_s'] for f in fan):.1f} s on the ranks, "
          f"{time.perf_counter() - t1:.1f} s for (b) and (c)")
    tmp.cleanup()
    print(f"ddp: one NCCL rank through the wrapped Trainer matches the unwrapped one and "
          f"all-reduces its buckets; two gloo ranks step as one process on their batch and "
          f"fan a volume's windows out as one process infers it "
          f"({time.perf_counter() - t0:.1f} s)")
    return {**a["launches"], "fanout": fan[0]["launches"]}


def phase_mesh(dev, card: str) -> dict:
    """FSDP and tensor parallelism (`parallel.fsdp`, `parallel.tensor`),
    two gloo ranks sharing the card (NCCL takes one rank a device), held to
    `DDP_TIMEOUT_S`, against this process on the global batch: (a) one
    f32 step of `MESH_SMALL` (the flagship's model at fs 24, 64^3, batch 2)
    under FSDP `[2]`, TP `[1, 2]` and TP + FSDP `[1, 2]`, each rank's loss
    within 1e-5, every gathered gradient leaf within 5e-5 and their sum
    within 1e-3, the parameters within the W5 bound; (b) the flagship at
    full width (fs 48, 96^3, bf16) under FSDP `[2]`, batch 1 a rank against
    batch 2 here: the losses of `MESH_STEPS` steps within 1e-3 relative
    (the bf16 repeat tolerance), the parameters after the first within
    the W5 bound, each step launching `PER_WINDOW` (its forward; the
    backward launches none) and the profiled step running those kernels
    by name, and each rank's bytes of masters and AdamW moments beside
    this process's.  Returns a rank's launches a flagship step."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    _spawn_ranks("mesh2", 2, root)
    ranks = [torch.load(root / f"mesh2_rank{r}.pt", weights_only=False) for r in range(2)]
    t_ranks = time.perf_counter() - t0

    trainer = Trainer(Config(**MESH_SMALL), device=dev)
    state = trainer.init_state()
    state, loss = trainer.train_step(state, _mesh_batch(dev, MESH_SMALL))
    want = _mesh_record(trainer, state, loss)
    del trainer, state
    for name in MESH_CASES:
        for r, res in enumerate(ranks):
            got = res[name]
            gaps = check_ddp_step(got, want, f"mesh {name} rank {r}")
            check(sum(got["placed"].values()) > 0, f"mesh {name}: rank {r} placed nothing")
        print(f"  mesh (a) {name}, 2 gloo ranks on '{card}', fs 24 64^3 f32, placed "
              f"{ranks[0][name]['placed']}: loss |diff| {gaps['loss']:.2e}, gradient gap "
              f"summed {gaps['summed']:.3e} (worst {gaps['worst']} {gaps['worst_gap']:.2e}), "
              f"parameters within W5 (excess {gaps['w5_excess']:.2e}); masters + moments a "
              f"rank {gib(ranks[0][name]['state_bytes'])} vs one process "
              f"{gib(want['state_bytes'])}")

    trainer = Trainer(Config(**FLAGSHIP), device=dev)
    state = trainer.init_state()
    batch = _mesh_batch(dev, FLAGSHIP)
    state, loss = trainer.train_step(state, batch)
    one = _mesh_record(trainer, state, loss)
    losses, one_ms = _stepped(trainer, state, batch, MESH_STEPS - 1)
    one_losses = [one["loss"], *losses]
    del trainer, state
    for r, res in enumerate(ranks):
        got = res["flagship"]
        gap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(got["losses"], one_losses))
        check(gap <= 1e-3, f"mesh flagship rank {r}: losses {got['losses']} vs {one_losses}")
        excess = _w5_excess(got["params"], one["params"])
        check(excess <= 0.0, f"mesh flagship rank {r}: parameters exceed W5 by {excess:.3e}")
        want_totals = {k: MESH_STEPS * v for k, v in PER_WINDOW.items()}
        check(got["launch_totals"] == want_totals and got["profiled"] == PER_WINDOW,
              f"mesh flagship rank {r}: {MESH_STEPS} steps launched "
              f"{got['launch_totals']}, the profiled step {got['profiled']}; want "
              f"{want_totals} and {PER_WINDOW}")
        got["launches"] = {k: v // MESH_STEPS for k, v in got["launch_totals"].items()}
        check(got["placed"]["fsdp"] > 0 and got["state_bytes"] < 0.6 * one["state_bytes"],
              f"mesh flagship rank {r}: {got['placed']} placed, {got['state_bytes']} bytes "
              f"against {one['state_bytes']}")
        print(f"  mesh (b) flagship fs 48 96^3 bf16, FSDP [2] rank {r} (batch 1) vs one "
              f"process (batch 2) on '{card}': losses {[round(v, 6) for v in got['losses']]} "
              f"vs {[round(v, 6) for v in one_losses]} (max relative gap {gap:.2e}); "
              f"parameters after the first step within W5 (excess {excess:.2e}); "
              f"{got['placed']['fsdp']} leaves sharded ({got['placed_elements']} of "
              f"{got['elements']} parameters); masters + AdamW moments "
              f"{got['state_bytes']} bytes ({gib(got['state_bytes'])}) vs one process "
              f"{one['state_bytes']} ({gib(one['state_bytes'])}); launches a step "
              f"{got['launches']}, profiled step {got['profiled']}, device busy "
              f"{got['busy_ms']:.2f} ms; step ms by events (two ranks sharing the card, "
              f"after the first) {[round(v, 2) for v in got['ms']]}, one process at batch 2 "
              f"{[round(v, 2) for v in one_ms]}")
    tmp.cleanup()
    print(f"mesh: FSDP, TP and TP + FSDP ranks step as one process on the global batch; "
          f"the flagship trains under FSDP with every kernel ({t_ranks:.1f} s of ranks, "
          f"{time.perf_counter() - t0:.1f} s)")
    return ranks[0]["flagship"]["launches"]


def phase_pipeline(dev, card: str) -> dict:
    """Pipeline parallelism (`parallel/pipeline.py`, the Trainer's GPipe
    step), gloo ranks sharing the card (NCCL takes one rank a device), held
    to `DDP_TIMEOUT_S`, against this process on the global batch of 2: the
    legs of `PP_LEGS`, each (a) one f32 step of its small model, every rank's
    loss within 1e-5, every gradient leaf within 5e-5 and their sum within
    1e-3, the parameters within the W5 bound; (b) `MESH_STEPS` bf16 steps of
    its full-width model: the losses within 1e-3 relative (the bf16 repeat
    tolerance), the parameters after the first within the W5 bound, every
    rank's masters bitwise equal after the first step and the last, each
    rank's launches its stage's `pp_launches`, counted and by name in a
    profiled step; each rank's step ms, device busy time and peak memory
    printed beside this process's.  The "pp4" ranks also run
    `PP_MESH_CASES` and `SP_BESIDE` (`pp_beside_modes`: the pipeline
    beside FSDP and TP, and spatial partitioning beside the pipeline, TP
    and a line of copies, TP over "data").  Both legs' ranks run at once,
    beside this process's references, so every time here is of a shared
    card.  Returns each leg's launches a step by stage ("pp4 fsdp": the
    flagship with FSDP on its line; `SP_BESIDE`'s by name)."""
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    procs = {leg: _start_ranks(leg, leg_cfg[0], root) for leg, leg_cfg in PP_LEGS.items()}
    # this process's references while the ranks run
    refs = {}
    for leg, (_, _, small, big) in PP_LEGS.items():
        trainer = Trainer(Config(**small), device=dev)
        state, loss = trainer.train_step(trainer.init_state(), _mesh_batch(dev, small))
        want = _mesh_record(trainer, state, loss)
        del trainer, state
        trainer = Trainer(Config(**big), device=dev)
        state = trainer.init_state()
        batch = _mesh_batch(dev, big)
        torch.cuda.reset_peak_memory_stats()
        state, loss = trainer.train_step(state, batch)
        one = _mesh_record(trainer, state, loss)
        losses, one_ms = _stepped(trainer, state, batch, MESH_STEPS - 1)
        refs[leg] = (want, one, [one["loss"], *losses], one_ms, torch.cuda.max_memory_allocated())
        del trainer, state
    for leg, ps in procs.items():
        _join_ranks(leg, ps)
    t_ranks = time.perf_counter() - t0
    launches = {}
    for leg, (world, par, small, big) in PP_LEGS.items():
        ranks = [torch.load(root / f"{leg}_rank{r}.pt", weights_only=False)
                 for r in range(world)]
        want, one, one_losses, one_ms, one_peak = refs[leg]
        name = f"{big['model_name']} {par['mesh_shape']}"
        lead = ranks[0]
        gaps = check_ddp_step(lead["small"], want, f"pipeline {name} (a)")
        check(all(r["small_digest"] == lead["small_digest"]
                  and r["small"]["loss"] == lead["small"]["loss"] for r in ranks),
              f"pipeline {name} (a): the ranks' masters or losses differ")
        print(f"  pipeline (a) {name}, {world} gloo ranks on '{card}', f32 "
              f"{small['roi_x']}^3, batch 2 in 2 microbatches vs one process: loss |diff| "
              f"{gaps['loss']:.2e}, gradient gap summed {gaps['summed']:.3e} (worst "
              f"{gaps['worst']} {gaps['worst_gap']:.2e}), parameters within W5 (excess "
              f"{gaps['w5_excess']:.2e}); every rank's masters bitwise equal")

        got = lead["big"]
        gap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(got["losses"], one_losses))
        check(gap <= 1e-3, f"pipeline {name}: losses {got['losses']} vs {one_losses}")
        excess = _w5_excess(got["params"], one["params"])
        check(excess <= 0.0, f"pipeline {name}: parameters exceed W5 by {excess:.3e}")
        check(all(r["big"]["losses"] == got["losses"] and r["big"]["digest"] == got["digest"]
                  and r["big"]["final_digest"] == got["final_digest"] for r in ranks),
              f"pipeline {name}: the ranks' losses or masters differ")
        want_launches = pp_launches(big, world, par["pp_microbatches"])
        for r, res in enumerate(ranks):
            rec, stage = res["big"], res["big"]["stage"]
            totals = {k: MESH_STEPS * v for k, v in want_launches[stage].items()}
            check(stage == r and rec["launch_totals"] == totals
                  and rec["profiled"] == want_launches[stage],
                  f"pipeline {name} rank {r} (stage {stage}): {MESH_STEPS} steps launched "
                  f"{rec['launch_totals']}, the profiled step {rec['profiled']}; want "
                  f"{totals} and {want_launches[stage]}")
            print(f"  pipeline (b) {name} bf16 {big['roi_x']}^3 rank {r} (stage {stage}) on "
                  f"'{card}': launches a step {want_launches[stage]} (counted and by name); "
                  f"step ms by events after the first {[round(v, 2) for v in rec['ms']]}, "
                  f"device busy {rec['busy_ms']:.2f} ms of the profiled step, peak memory "
                  f"{gib(rec['peak'])}")
        print(f"  pipeline (b) {name}: losses {[round(v, 6) for v in got['losses']]} vs one "
              f"process {[round(v, 6) for v in one_losses]} (max relative gap {gap:.2e}); "
              f"parameters after the first step within W5 (excess {excess:.2e}); every "
              f"rank's masters bitwise equal; one process at batch 2 on '{card}' (beside "
              f"the ranks): step ms {[round(v, 2) for v in one_ms]}, peak memory "
              f"{gib(one_peak)}")
        launches[leg] = want_launches
        print(f"  pipeline {name}: rank 0's seconds by part "
              f"{ {k: round(v, 1) for k, v in lead['seconds'].items()} }")
        if leg == "pp4":
            launches.update(pp_beside_modes(ranks, refs, want_launches, card))
    tmp.cleanup()
    print(f"pipeline: the flagship's swin stages on [1, 4] (alone and with FSDP on 'pp') and "
          f"C-UNETR's ViT on [1, 2] step as one process on the batch, every kernel on its "
          f"stage, and beside FSDP, TP and spatial partitioning, as spatial partitioning does "
          f"beside TP (all legs' {sum(w for w, *_ in PP_LEGS.values())} "
          f"ranks at once beside this process's references, {t_ranks:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s)")
    return launches


def pp_beside_modes(ranks: list, refs: dict, want_launches: list, card: str) -> list:
    """`phase_pipeline`'s checks of `PP_MESH_CASES` in the "pp4" ranks: (d)
    each f32 step against this process's (`check_ddp_step`, rank 0's
    gathered record), every rank's loss equal and the masters bitwise
    equal over every rank (a "model" line's copies averaged as "data");
    (e) the flagship on [1, 4] with FSDP on "pp": the losses of
    `PP_FSDP_STEPS` steps within 1e-3 relative of one process's, the
    parameters after the first within W5, every rank's masters bitwise
    equal, each rank's launches its stage's, counted and by name, and its
    masters plus moments under half PP alone's; (f) `SP_BESIDE` under
    (e)'s gates over `MESH_STEPS` steps against this process's references
    of the same model and batch, each rank's launches (counted, modes
    apart) those the level rule predicts for its stage (`pp_launches` of
    `sp_launches(2, ...)`) or its slab (`sp_launches(2)`).  Returns the
    launches a step by stage of (e) and of (f) (one entry a rank's for sp
    x tp)."""
    for name, (_, model) in PP_MESH_CASES.items():
        want = refs["pp4" if model is MESH_SMALL else "pp2"][0]
        recs = [r["mesh"][name] for r in ranks]
        gaps = check_ddp_step(recs[0], want, f"pipeline {name} (d)")
        check(all(r["loss"] == recs[0]["loss"] for r in recs),
              f"pipeline {name} (d): the ranks' losses differ")
        digests = [r["digest"] for r in recs]
        check(len(set(digests)) == 1,
              f"pipeline {name} (d): the ranks' masters differ (by rank, pipeline lines "
              f"{sorted({tuple(r['line']) for r in recs})}): {[d[:8] for d in digests]}")
        print(f"  pipeline (d) {name}, {model['model_name']} f32 {model['roi_x']}^3 on "
              f"'{card}', batch 2, placed {recs[0]['placed']}: loss |diff| {gaps['loss']:.2e}, "
              f"gradient gap summed {gaps['summed']:.3e} (worst {gaps['worst']} "
              f"{gaps['worst_gap']:.2e}), parameters within W5 (excess "
              f"{gaps['w5_excess']:.2e}); masters bitwise equal over every rank; masters + "
              f"moments a rank "
              f"{gib(recs[0]['state_bytes'])} vs one process {gib(want['state_bytes'])}")
    _, one, one_losses, _, _ = refs["pp4"]
    got = ranks[0]["fsdp"]
    gap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(got["losses"], one_losses))
    check(gap <= 1e-3, f"pipeline + fsdp: losses {got['losses']} vs {one_losses}")
    excess = _w5_excess(got["params"], one["params"])
    check(excess <= 0.0, f"pipeline + fsdp: parameters exceed W5 by {excess:.3e}")
    check(all(r["fsdp"]["losses"] == got["losses"] and r["fsdp"]["digest"] == got["digest"]
              and r["fsdp"]["final_digest"] == got["final_digest"] for r in ranks),
          "pipeline + fsdp: the ranks' losses or masters differ")
    for r, res in enumerate(ranks):
        rec, alone, stage = res["fsdp"], res["big"], res["fsdp"]["stage"]
        totals = {k: PP_FSDP_STEPS * v for k, v in want_launches[stage].items()}
        check(stage == r and rec["launch_totals"] == totals
              and rec["profiled"] == want_launches[stage],
              f"pipeline + fsdp rank {r} (stage {stage}): {PP_FSDP_STEPS} steps launched "
              f"{rec['launch_totals']}, the profiled step {rec['profiled']}; want {totals} "
              f"and {want_launches[stage]}")
        check(rec["placed"]["fsdp"] > 0 and rec["state_bytes"] < 0.5 * alone["state_bytes"],
              f"pipeline + fsdp rank {r}: {rec['placed']} placed, {rec['state_bytes']} bytes "
              f"against PP alone's {alone['state_bytes']}")
        print(f"  pipeline (e) flagship bf16 [1, 4] + FSDP on 'pp' rank {r} (stage {stage}) on "
              f"'{card}': launches a step {want_launches[stage]} (counted and by name); "
              f"masters + moments {rec['state_bytes']} bytes ({gib(rec['state_bytes'])}, "
              f"{rec['state_bytes'] / alone['state_bytes']:.1%} of PP alone's "
              f"{gib(alone['state_bytes'])}); step ms by events after the first "
              f"{[round(v, 2) for v in rec['ms']]} (PP alone {[round(v, 2) for v in alone['ms']]}"
              f"), device busy {rec['busy_ms']:.2f} ms (PP alone {alone['busy_ms']:.2f}), peak "
              f"memory {gib(rec['peak'])} (PP alone {gib(alone['peak'])})")
    print(f"  pipeline (e) flagship + FSDP on 'pp': losses {[round(v, 6) for v in got['losses']]}"
          f" vs one process {[round(v, 6) for v in one_losses[:PP_FSDP_STEPS]]} (max relative "
          f"gap {gap:.2e}); parameters after the first step within W5 (excess {excess:.2e}); "
          f"every rank's masters bitwise equal; {got['placed_elements']} of "
          f"{got['elements']} parameters sharded")
    out = {"pp4 fsdp": want_launches}
    for name, (kind, par) in SP_BESIDE.items():
        big = UNETR if kind == "unetr" else FLAGSHIP
        _, one, one_losses, one_ms, one_peak = refs["pp2" if kind == "unetr" else "pp4"]
        recs = [r["sp"][name] for r in ranks]
        got = recs[0]
        gap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(got["losses"], one_losses))
        check(gap <= 1e-3, f"{name}: losses {got['losses']} vs one process {one_losses}")
        excess = _w5_excess(got["params"], one["params"])
        check(excess <= 0.0, f"{name}: parameters exceed W5 by {excess:.3e}")
        check(all(r["losses"] == got["losses"] and r["digest"] == got["digest"]
                  and r["final_digest"] == got["final_digest"] for r in recs),
              f"{name}: the ranks' losses or masters differ")
        window = sp_launches(2, model=kind)
        want = (pp_launches(big, 2, par["pp_microbatches"], window) if kind == "unetr"
                else [window])
        out[name] = want
        for r, rec in enumerate(recs):
            stage = rec["coords"].get("pp", 0)
            totals = {k: MESH_STEPS * v for k, v in want[stage].items()}
            check(rec["sp_top"] == (96, 96) and rec["launch_totals"] == totals,
                  f"{name} rank {r} ({rec['coords']}): patch {rec['sp_top']}, {MESH_STEPS} "
                  f"steps launched {rec['launch_totals']}; want {totals}")
            print(f"  pipeline (f) {name} {big['model_name']} bf16 96^3 batch 2 rank {r} "
                  f"{rec['coords']} on '{card}': launches a step {want[stage]} (counted, "
                  f"modes apart); step ms by events after the first "
                  f"{[round(v, 2) for v in rec['ms']]}; masters + moments {rec['state_bytes']} B "
                  f"({rec['placed']} placed); peak memory {gib(rec['peak'])} ({rec['peak']} B)")
        print(f"  pipeline (f) {name}: losses {[round(v, 6) for v in got['losses']]} vs one "
              f"process {[round(v, 6) for v in one_losses]} (max relative gap {gap:.2e}); "
              f"parameters after the first step within W5 (excess {excess:.2e}); every rank's "
              f"masters bitwise equal; one process at batch 2 on '{card}' (beside the ranks): "
              f"step ms {[round(v, 2) for v in one_ms]}, peak memory {gib(one_peak)} "
              f"({one_peak} B)")
    return out


# ---- spatial partitioning (phase_spatial) ----------------------------------
# K4's D-halo mode at the flagship's sharded shapes: (label, halo'd slab
# [B, Dl + 2, H, W, Cin], Cout, prologue, the K4 kernel the C planner picks,
# the line's size n: the whole volume has Dl * n planes)
SP_CONVS = [
    ("96^3 sp[2] encoder1/decoder1 conv2", (1, 48 + 2, 96, 96, 48), 48, True,
     "miseg_k4_conv_brick", 2),
    ("96^3 sp[4] encoder1/decoder1 conv2", (1, 24 + 2, 96, 96, 48), 48, True,
     "miseg_k4_conv_brick", 4),
    ("24^3 sp[2] encoder3/decoder3 conv2", (1, 12 + 2, 24, 24, 96), 96, True,
     "miseg_k4_conv_coarse", 2),
    # no 4x4x4 brick divides a slab of 6 planes, and it holds more than 256
    # voxels: the CUDA-core kernel (a ROADMAP item, not redesigned here)
    ("12^3 sp[2] encoder4/decoder4 conv2", (1, 6 + 2, 12, 12, 192), 192, True,
     ("miseg_k4_conv_fma", "miseg_k4_splitk_reduce"), 2),
    ("96^3 sp[2] encoder1 conv1 (Cin = 1)", (1, 48 + 2, 96, 96, 1), 48, False,
     "miseg_k4_conv_cin1", 2),
]
# C-UNETR's distinct kinds of K4 D-halo call at 96^3 on sp [2] (fs 16):
# encoder1's Cin = 1 conv, the 96^3 and 48^3 bricks, and decoder5's 12^3
# slab of 6 planes, which no brick divides (the FMA kernel, as the
# flagship's 12^3 slab)
SP_UNETR_CONVS = [
    ("C-UNETR 96^3 sp[2] encoder1 conv1 (Cin = 1)", (1, 48 + 2, 96, 96, 1), 16, False,
     "miseg_k4_conv_cin1", 2),
    ("C-UNETR 96^3 sp[2] encoder1/decoder2 conv2", (1, 48 + 2, 96, 96, 16), 16, True,
     "miseg_k4_conv_brick", 2),
    ("C-UNETR 48^3 sp[2] encoder2 block1/decoder3 conv2", (1, 24 + 2, 48, 48, 32), 32, True,
     "miseg_k4_conv_brick", 2),
    ("C-UNETR 12^3 sp[2] decoder5 conv2", (1, 6 + 2, 12, 12, 128), 128, True,
     ("miseg_k4_conv_fma", "miseg_k4_splitk_reduce"), 2),
]
# K1's moments mode at the top slabs of sp [2]: the flagship's encoder1
# projected-residual norm at 96^3, and the 2-D flagship's 96x96 slice
SP_MOMENTS = [(1, 48 * 96 * 96, 48), (1, 48 * 96, 48)]


def k4_halo_case(label: str, shape, cout: int, prologue: bool, kernel: str, n: int, dev,
                 gen, mem_bw: float, bf16_flops: float, flush, yardsticks: bool = False):
    """K4's D-halo mode at `shape` (bf16) against its plain version for each
    pair of edge flags (y within one bf16 ulp of its scale, the fold's
    moments mode within 1e-5 relative of the plain moments of the kernel's
    own y), the K4 kernel it launches by name (`kernel`), a repeat
    bit-identical; with the interior flags its CUDA-event and device times
    beside its bound, the plain version's, the whole volume's call
    (`conv3_norm_columns` on Dl * n planes) and `F.conv3d` on the halo'd
    slab (padding 0 on D) by events, and with `yardsticks` the device times
    of those two as well.  Returns (the lines, the `kernels` row)."""
    import itertools

    import torch.nn.functional as F

    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    b, dh, hh, wh, cin = shape
    dl = dh - 2
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, torch.bfloat16)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen) / (27 * cin) ** 0.5).to(
        dev, torch.bfloat16)
    kw = {}
    if prologue:
        kw = dict(scale=(1 + 0.3 * torch.randn((b, cin), generator=gen)).to(dev),
                  shift=(0.3 * torch.randn((b, cin), generator=gen)).to(dev), slope=0.01)
    lines, errs = [], []
    for lo, hi in itertools.product((False, True), repeat=2):
        y, mean, m2 = fc.conv3_halo_moments(x, w, pad_lo=lo, pad_hi=hi, **kw)
        ref = fc.conv3_halo_moments_plain(x, w, pad_lo=lo, pad_hi=hi, **kw)[0]
        e, tol = max_err(y, ref), tolerance(ref, torch.bfloat16)
        check(y.shape == ref.shape and e <= tol,
              f"K4 halo {label} flags {lo, hi}: {e:.3e} > {tol:.3e}")
        rm, rq = fn.channel_moments_plain(y.reshape(b, -1, cout))
        em = max(max_err(mean, rm) / (1 + float(rm.abs().max())),
                 max_err(m2, rq) / (1 + float(rq.abs().max())))
        check(em <= 1e-5, f"K4 halo {label} flags {lo, hi}: moments rel err {em:.2e}")
        errs.append(e)
        lines.append(f"  K4 halo {label} {list(shape)}->{cout} bf16 flags (low, high) "
                     f"{int(lo), int(hi)}: err {e:.3e} (tol {tol:.3e}), moments rel err "
                     f"{em:.2e} (tol 1e-05)")
    call = lambda: fc.conv3_halo_moments(x, w, **kw)  # noqa: E731
    names = k4_kernel_names(call)
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    check(bool(names) and all(any(k in nm for k in kernels) for nm in names),
          f"K4 halo {label}: launched {sorted(set(names))}, want only {kernels}")
    again = call()
    check(all(torch.equal(a, c) for a, c in zip(call(), again)),
          f"K4 halo {label}: a repeated call is not bit-identical")
    whole = (torch.randn((b, dl * n, hh, wh, cin), generator=gen) * 1.5 + 0.3).to(
        dev, torch.bfloat16)
    ms = time_ms(call)
    plain = time_ms(lambda: fc.conv3_halo_moments_plain(x, w, **kw), reps=5)
    whole_ms = time_ms(lambda: fc.conv3_norm_columns(whole, w, **kw))
    xcf = x.permute(0, 4, 1, 2, 3)
    lib = time_ms(lambda: F.conv3d(xcf, w, padding=(0, 1, 1)))
    dev_k4 = device_ms(call, "miseg_k4_", flush=flush)
    dev_whole = dev_lib = None
    if yardsticks:
        dev_whole = device_ms(lambda: fc.conv3_norm_columns(whole, w, **kw), "miseg_k4_",
                              flush=flush)
        dev_lib = device_ms(lambda: F.conv3d(xcf, w, padding=(0, 1, 1)), flush=flush)
    s_out = dl * hh * wh
    nbytes = ((x.numel() + w.numel() + b * s_out * cout) * 2 + 2 * b * cin * 4 * prologue
              + 2 * b * cout * 4)
    flops = 2 * b * s_out * 27 * cin * cout
    bound = max(nbytes / mem_bw, flops / bf16_flops) * 1e3
    by = "bytes" if nbytes / mem_bw >= flops / bf16_flops else "operations"
    lines.append(f"    kernel {names[0][:90]}\n    times ms: K4 halo {ms:.4f} (bound "
                 f"{bound:.4f} by {by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain "
                 f"{plain:.4f}, whole volume ({dl * n} planes) K4 {whole_ms:.4f}, F.conv3d on "
                 f"the halo'd slab {lib:.4f}\n    device ms (L2 flushed): K4 halo kernel "
                 f"{fmt_ms(dev_k4)}, whole volume {fmt_ms(dev_whole)}, F.conv3d "
                 f"{fmt_ms(dev_lib)}")
    row = dict(shape=list(shape), cout=cout, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
               library_ms=lib, max_abs_err=max(errs), device_ms=dev_k4,
               whole_volume_ms=whole_ms, whole_volume_device_ms=dev_whole,
               library_device_ms=dev_lib, kernel=names[0])
    return "\n".join(lines), row


def spatial_kernels(dev, mem_bw: float, bf16_flops: float) -> dict:
    """`phase_spatial` (a): K4's D-halo mode at `SP_CONVS` and
    `SP_UNETR_CONVS`, K1's moments mode at `SP_MOMENTS` and the fold's
    moments mode over the 96^3 slab's 1728 bricks, each against its plain
    version, with times.  Returns the `kernels` rows of "K4 halo" (with
    C-UNETR's shapes under "unetr_shapes"), "K1 moments" (the 2-D slab's
    under "two_d_shape") and "K1 fold moments"."""
    from miseg_tpu_torch.ops.kernels import fused_conv as fc
    from miseg_tpu_torch.ops.kernels import fused_norm as fn

    fn._k1(), fc._entry()
    gen = torch.Generator().manual_seed(20)
    flush = l2_flush(dev)
    rows = {}
    for label, shape, cout, prologue, kernel, n in SP_CONVS:
        main = label.startswith("96^3 sp[2] encoder1/decoder1")
        line, row = k4_halo_case(label, shape, cout, prologue, kernel, n, dev, gen, mem_bw,
                                 bf16_flops, flush, yardsticks=main)
        print(line)
        if main:
            rows["K4 halo"] = row
    rows["K4 halo"]["unetr_shapes"] = []
    for label, shape, cout, prologue, kernel, n in SP_UNETR_CONVS:
        line, row = k4_halo_case(label, shape, cout, prologue, kernel, n, dev, gen, mem_bw,
                                 bf16_flops, flush)
        print(line)
        rows["K4 halo"]["unetr_shapes"].append({"label": label, **row})
    moments = []
    for shape in SP_MOMENTS:
        x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, torch.bfloat16)
        mean, m2 = fn.channel_moments(x)
        rm, rq = fn.channel_moments_plain(x)
        e = max(max_err(mean, rm) / (1 + float(rm.abs().max())),
                max_err(m2, rq) / (1 + float(rq.abs().max())))
        check(e <= 1e-5, f"K1 moments {shape}: relative error {e:.2e} > 1e-5")
        nbytes = x.numel() * x.element_size()
        k1 = hbm_and_l2(lambda: fn.channel_moments(x), "miseg_k1_", nbytes, flush)
        plain = time_ms(lambda: fn.channel_moments_plain(x))
        lib = time_ms(lambda: torch.var_mean(x, dim=1, correction=0), flush=flush)
        bound = nbytes / mem_bw * 1e3
        print(f"  K1 moments {list(shape)} bf16: rel err {e:.2e} (tol 1e-05)\n    times ms: "
              f"K1 moments {fmt_hbm_l2(k1)} (bound {bound:.5f} by bytes), plain "
              f"{plain:.4f}, torch.var_mean {lib:.4f}")
        moments.append(dict(shape=list(shape), ms=k1["hbm"][0], plain_ms=plain,
                            bound_ms=bound, bound_by="bytes", library_ms=lib,
                            max_abs_err=max(max_err(mean, rm), max_err(m2, rq))))
    rows["K1 moments"] = {**moments[0], "two_d_shape": moments[1]}
    s_vox, tile = 48 * 96 * 96, 256
    n_tiles = s_vox // tile
    part = torch.stack([torch.randn((n_tiles, 48), generator=gen) + 0.5,
                        torch.rand((n_tiles, 48), generator=gen) * tile]).to(dev)
    got = fn.fold_launch(part, s_vox, tile, n_tiles, moments=True)
    want = fn.fold_moments_plain(part, s_vox, tile, n_tiles)
    ef = max(max_err(a, c) / (1 + float(c.abs().max())) for a, c in zip(got, want))
    check(ef <= 1e-5, f"K1 fold moments {n_tiles} partials: relative error {ef:.2e}")
    fold = time_ms(lambda: fn.fold_launch(part, s_vox, tile, n_tiles, moments=True))
    fold_plain = time_ms(lambda: fn.fold_moments_plain(part, s_vox, tile, n_tiles))
    dev_fold = device_ms(lambda: fn.fold_launch(part, s_vox, tile, n_tiles, moments=True),
                         "miseg_k1_")
    fbound = (part.numel() * 4 + 2 * 48 * 4) / mem_bw * 1e3
    print(f"  K1 fold moments {n_tiles} partials x 48: rel err {ef:.2e} (tol 1e-05)\n    "
          f"times ms: fold {fold:.4f} (device {fmt_ms(dev_fold)}; bound {fbound:.5f} by "
          f"bytes), plain {fold_plain:.4f}")
    rows["K1 fold moments"] = dict(shape=[2, n_tiles, 48], ms=fold, plain_ms=fold_plain,
                                   bound_ms=fbound, bound_by="bytes", library_ms=None,
                                   max_abs_err=max(max_err(a, c) for a, c in zip(got, want)))
    return rows


SP_2 = dict(spatial_shard=True, mesh_shape=[2], mesh_axes=["sp"])
# phase_spatial (d): the same line with FSDP on it
SP_2_FSDP = dict(SP_2, fsdp=True, fsdp_axis="sp")
# phase_spatial (b): C-UNet (fs 16) and the flagship's model at fs 24, 64^3, f32
SP_SMALL = {"C-UNet fs 16": {**CUNET, "roi_x": 64, "roi_y": 64, "roi_z": 64, "no_amp": True},
            "C-Swin-UNETR fs 24": MESH_SMALL}
# phase_spatial (b) on the two ranks: the fs 24 swin with tensor parallelism
# over "data" (its leaves gathered a step, as FSDP's) and on the spatial
# line (the same, the patch partitioned)
SP_TP_CASES = {"tp over data [2]": dict(mesh_shape=[2], mesh_axes=["data"],
                                        tensor_parallel=True, tp_axis="data"),
               "tp on the spatial line [2]": dict(SP_2, tensor_parallel=True, tp_axis="sp")}


def sp_launches(n: int, roi: int = 96, model: str = "flagship") -> dict:
    """A model's launches a step on each rank of a spatial line of `n` ranks
    (its forward; the backward launches none), by the level rule: a level
    of D (H in 2-D) = r is sharded when r % 2n == 0, and there its norms
    take K1's moments mode, its convs K4's D-halo mode and their folds the
    moments mode.
      * "flagship" (C-Swin-UNETR, 3-D) and "two_d" (its 2-D twin): swin
        norms (K1 + K2): `proj_out` at 48^3..3^3, 4 a stage (2 blocks x
        norm1, norm2) at 48^3..6^3, each merging's at 24^3..3^3; the 10
        UnetResBlocks: in 3-D two K4 calls and two folds each, plus K1 +
        K3 (projected residual) or K2 (identity); in 2-D (cuDNN convs)
        norm1 and norm2, and norm3 where projected, K1 + K2 each; one K5
        a swin block, every rank holding window rows.
      * "unetr" (C-UNETR): the ViT's 25 norms (K1 + K2) run whole on every
        rank; its 8 UnetResBlocks (encoder1 and decoder2 at 96^3, encoder2's
        block1 and decoder3 at 48^3, encoder2's block0, encoder3's block0
        and decoder4 at 24^3, decoder5 at 12^3) two K4 calls and two folds
        each, plus K1 + K3 for the 5 projected residuals (encoder1,
        decoder5..2) or K2 for the 3 identity ones.
      * "vanilla" (UNetVanilla at the README recipe, strides 1 2 2 2 1):
        6 norms a scale on the down path (48^3, 24^3, 12^3, and 12^3 again
        for the stride-1 bottom) and 2 a unit on the up path (12^3, 24^3,
        48^3, 96^3), K1 + K2 each."""
    sharded = lambda r: r % (2 * n) == 0  # noqa: E731
    out = dict.fromkeys((*PER_WINDOW, "K1 moments", "K1 fold moments", "K4 halo"), 0)

    def norms(r: int, count: int = 1) -> None:
        out["K1 moments" if sharded(r) else "K1"] += count
        out["K2"] += count

    def fused_block(r: int, projected: bool) -> None:
        out["K4 halo" if sharded(r) else "K4"] += 2
        out["K1 fold moments" if sharded(r) else "K1 fold"] += 2
        if projected:
            out["K1 moments" if sharded(r) else "K1"] += 1
            out["K3"] += 1
        else:
            out["K2"] += 1

    if model == "unetr":
        out["K1"] += 25
        out["K2"] += 25
        for r, projected in ((roi, True), (roi // 2, False), (roi // 4, False),
                             (roi // 4, False), (roi // 8, True), (roi // 4, True),
                             (roi // 2, True), (roi, True)):
            fused_block(r, projected)
        return out
    if model == "vanilla":
        for r in (roi // 2, roi // 4, roi // 8, roi // 8):
            norms(r, 6)
        for r in (roi // 8, roi // 4, roi // 2, roi):
            norms(r, 2)
        return out
    levels = [roi // 2 ** k for k in range(6)]          # 96 .. 3
    for r in levels:
        norms(r, (r != roi) + 4 * (roi // 2 >= r >= roi // 16) + (r <= roi // 4))
    blocks = [(roi, True), (roi // 2, False), (roi // 4, False), (roi // 8, False),
              (roi // 32, False), (roi // 16, True), (roi // 8, True), (roi // 4, True),
              (roi // 2, True), (roi, True)]
    for r, projected in blocks:
        if model == "two_d":
            norms(r, 2 + projected)
        else:
            fused_block(r, projected)
    for r in levels[1:5]:   # the four stages, 2 blocks each; every rank holds window rows
        rows = -(-r // 7) if r > 7 else 1
        check(not sharded(r) or rows >= n, f"sp_launches: {rows} window rows over {n} ranks")
        out["K5"] += 2
    return out


# phase_spatial (e): the other model families at full width on sp [2], bf16,
# batch 1: (config, `sp_launches` model)
SP_MODELS = {"C-UNETR": (UNETR, "unetr"), "UNetVanilla": (VANILLA, "vanilla"),
             "2-D flagship": (TWO_D, "two_d")}
# bf16 steps of each full-width model of phase_spatial (c), (d) and (e); the
# first is held to one process
SP_STEPS = 2


def sp_model_steps(trainer, dev, model: dict) -> dict:
    """`SP_STEPS` bf16 steps of `model` at batch 1 from the trainer's
    init: the first step's loss and parameters, every loss and CUDA-event
    ms, the launches of all the steps (counted from 0 before the first,
    modes apart), the spatial collectives a step and the peak memory; on a
    partitioned patch then one profiled step after a lead step, its
    kernels by name; and the seconds of each part."""
    from miseg_tpu_torch.parallel import spatial

    t0 = time.perf_counter()
    state = trainer.init_state()
    batch = _mesh_batch(dev, model, n=1)
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    spatial.collectives.update(dict.fromkeys(spatial.collectives, 0))
    state, loss = trainer.train_step(state, batch)
    rec = _mesh_record(trainer, state, loss)
    rec["grads"] = None   # the gates read the losses, the parameters and the digests
    losses, rec["ms"] = _stepped(trainer, state, batch, SP_STEPS - 1)
    rec["launch_totals"] = {**launch_counts(), **mode_counts()}
    rec["collectives"] = {k: v // SP_STEPS for k, v in spatial.collectives.items()}
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["losses"] = [rec["loss"], *losses]
    t_steps = time.perf_counter()
    rec["digest"] = _digest(rec["params"])
    rec["final_digest"] = _digest(trainer.state_dict(state))
    rec["sp_top"] = trainer._sp_top
    t_digests = time.perf_counter()
    if trainer._sp_top is not None:
        events = profiled(lambda: trainer.train_step(state, batch), lambda ev: True,
                          attempts=1, lead=lambda: trainer.train_step(state, batch), cpu=False)
        rec["profiled"] = replay_counts(events)
        rec["k4_kernels"] = [e.name for e in events if "miseg_k4_" in e.name]
        rec["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    rec["parts_s"] = {"init": t_init - t0, "steps": t_steps - t_init,
                      "digests": t_digests - t_steps,
                      "profiled": time.perf_counter() - t_digests}
    return rec


def sp_rank(dev) -> dict:
    """A rank of `phase_spatial` (leg "sp2"): (b) one f32 step of each of
    `SP_SMALL` on the line `[2]`, and of the fs 24 swin on each of
    `SP_TP_CASES`; (c) `SP_STEPS` bf16 steps of the
    flagship at batch 1, launches and collectives counted from 0 before the
    first and read after the last, the peak memory, then one profiled step
    (both ranks profile one lead and one step: each step holds
    collectives); (d) with FSDP on the line (`SP_2_FSDP`): one f32 step of
    the fs 24 swin, and `SP_STEPS` bf16 steps of the flagship, launches
    counted from 0 before the first and read after the last, the peak
    memory and the bytes of masters and moments a rank; (e) each of
    `SP_MODELS` on the line (`sp_model_steps`).  Rank 0 keeps the whole
    records, every rank the digests."""
    from miseg_tpu_torch import parallel
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.parallel import spatial
    from miseg_tpu_torch.train.engine import Trainer

    out = {}
    for name, small in SP_SMALL.items():
        trainer = Trainer(Config(**small, **SP_2), device=dev)
        state, loss = trainer.train_step(trainer.init_state(), _mesh_batch(dev, small))
        out[name] = _mesh_record(trainer, state, loss)
        out[name]["digest"] = _digest(out[name]["params"])
        del trainer, state
    for name, par in SP_TP_CASES.items():
        trainer = Trainer(Config(**MESH_SMALL, **par), device=dev)
        state, loss = trainer.train_step(trainer.init_state(),
                                         _share(_mesh_batch(dev, MESH_SMALL)))
        out[name] = _mesh_record(trainer, state, loss)
        out[name]["digest"] = _digest(out[name]["params"])
        del trainer, state
    trainer = Trainer(Config(**FLAGSHIP, **SP_2), device=dev)
    state = trainer.init_state()
    batch = _mesh_batch(dev, FLAGSHIP, n=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    spatial.collectives.update(dict.fromkeys(spatial.collectives, 0))
    state, loss = trainer.train_step(state, batch)
    rec = _mesh_record(trainer, state, loss)
    losses, rec["ms"] = _stepped(trainer, state, batch, SP_STEPS - 1)
    rec["launch_totals"] = {**launch_counts(), **mode_counts()}
    rec["collectives"] = {k: v // SP_STEPS for k, v in spatial.collectives.items()}
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["losses"] = [rec["loss"], *losses]
    rec["digest"] = _digest(rec["params"])
    rec["final_digest"] = _digest(state.params)
    rec["sp_top"] = trainer._sp_top
    events = profiled(lambda: trainer.train_step(state, batch), lambda ev: True, attempts=1,
                      lead=lambda: trainer.train_step(state, batch), cpu=False)
    rec["profiled"] = replay_counts(events)
    rec["k4_kernels"] = [e.name for e in events if "miseg_k4_" in e.name]
    rec["busy_ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    rec["grads"] = None   # (c) and (d) read the losses, parameters and digests
    out["flagship"] = rec
    del trainer, state
    t0 = time.perf_counter()
    small = SP_SMALL["C-Swin-UNETR fs 24"]
    trainer = Trainer(Config(**small, **SP_2_FSDP), device=dev)
    state, loss = trainer.train_step(trainer.init_state(), _mesh_batch(dev, small))
    out["fsdp small"] = _mesh_record(trainer, state, loss)
    out["fsdp small"]["digest"] = _digest(out["fsdp small"]["params"])
    del trainer, state
    torch.cuda.empty_cache()
    trainer = Trainer(Config(**FLAGSHIP, **SP_2_FSDP), device=dev)
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, loss = trainer.train_step(state, batch)
    rec = _mesh_record(trainer, state, loss)
    losses, rec["ms"] = _stepped(trainer, state, batch, SP_STEPS - 1)
    rec["launch_totals"] = {**launch_counts(), **mode_counts()}
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["losses"] = [rec["loss"], *losses]
    rec["digest"] = _digest(rec["params"])
    rec["final_digest"] = _digest(trainer.state_dict(state))
    rec["sp_top"] = trainer._sp_top
    rec["axes"] = sorted({pl.axis for pl in trainer.placements.values()})
    rec["seconds"] = time.perf_counter() - t0
    rec["grads"] = None   # (c) and (d) read the losses, parameters and digests
    out["fsdp flagship"] = rec
    del trainer, state
    for name, (model, _) in SP_MODELS.items():
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trainer = Trainer(Config(**model, **SP_2), device=dev)
        out[name] = sp_model_steps(trainer, dev, model)
        out[name]["seconds"] = time.perf_counter() - t0
        del trainer
    if not parallel.is_writer():   # the whole tensors once, from rank 0
        for r in out.values():
            r["params"] = r["grads"] = None
    return out


def phase_spatial(dev, card: str, mem_bw: float, bf16_flops: float) -> dict:
    """Spatial partitioning: (a) `spatial_kernels`; (b) and (c) two gloo
    ranks sharing the card (NCCL takes one rank a device) on the line `[2]`
    (`sp_rank`), held to `DDP_TIMEOUT_S`, against this process, whose
    references run beside them (so every time here is of a shared card):
    (b) each small model's step within `check_ddp_step`'s gates, both
    ranks' masters bitwise equal (and so `SP_TP_CASES`', tensor
    parallelism over "data" and on the spatial line); (c) the flagship's losses within 1e-3
    relative of one process at the same patch and batch, its parameters
    after the first step within W5, the masters bitwise equal, each rank's
    launches `sp_launches(2)` a step (counted, and by name in the profiled
    step), the K4 kernel of each call, the collectives a step, step ms and
    peak memory beside one process's; (d) the same with FSDP on the line:
    the fs 24 swin's step under (b)'s gates, the flagship's under (c)'s
    (launches `sp_launches(2)` a step, counted), its bytes of masters and
    moments and peak a rank beside SP alone's; (e) C-UNETR, UNetVanilla
    and the 2-D flagship at full width (`SP_MODELS`) under (c)'s gates,
    each rank's launches a step `sp_launches(2, model=...)`.  Returns the
    rows of the modes and a rank's launches a step of each model."""
    from collections import Counter

    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    t0 = time.perf_counter()
    rows = spatial_kernels(dev, mem_bw, bf16_flops)
    t_kernels = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    procs = _start_ranks("sp2", 2, root)
    refs = {}
    for name, small in SP_SMALL.items():
        trainer = Trainer(Config(**small), device=dev)
        state, loss = trainer.train_step(trainer.init_state(), _mesh_batch(dev, small))
        refs[name] = _mesh_record(trainer, state, loss)
        del trainer, state
    trainer = Trainer(Config(**FLAGSHIP), device=dev)
    state = trainer.init_state()
    batch = _mesh_batch(dev, FLAGSHIP, n=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, loss = trainer.train_step(state, batch)
    one = _mesh_record(trainer, state, loss)
    losses, one_ms = _stepped(trainer, state, batch, SP_STEPS - 1)
    one_losses, one_peak = [one["loss"], *losses], torch.cuda.max_memory_allocated()
    del trainer, state
    model_refs = {}
    for name, (model, _) in SP_MODELS.items():
        torch.cuda.empty_cache()
        trainer = Trainer(Config(**model), device=dev)
        model_refs[name] = sp_model_steps(trainer, dev, model)
        del trainer
    _join_ranks("sp2", procs)
    t_ranks = time.perf_counter() - t0 - t_kernels
    ranks = [torch.load(root / f"sp2_rank{r}.pt", weights_only=False) for r in range(2)]
    for name in SP_SMALL:
        gaps = check_ddp_step(ranks[0][name], refs[name], f"spatial (b) {name}")
        if name == "C-Swin-UNETR fs 24":   # (d) beside FSDP, the same gates
            fgaps = check_ddp_step(ranks[0]["fsdp small"], refs[name],
                                   f"spatial (d) {name} + FSDP")
            check(ranks[0]["fsdp small"]["digest"] == ranks[1]["fsdp small"]["digest"]
                  and ranks[0]["fsdp small"]["placed"]["fsdp"] > 0,
                  f"spatial (d) {name} + FSDP: the ranks' masters differ or nothing is placed")
            print(f"  spatial (d) {name} 64^3 f32, sp [2] + FSDP on 'sp', 2 gloo ranks on "
                  f"'{card}' vs one process at batch 2: loss |diff| {fgaps['loss']:.2e}, "
                  f"gradient gap summed {fgaps['summed']:.3e} (worst {fgaps['worst']} "
                  f"{fgaps['worst_gap']:.2e}), parameters within W5 (excess "
                  f"{fgaps['w5_excess']:.2e}); masters bitwise equal; "
                  f"{ranks[0]['fsdp small']['placed']['fsdp']} leaves sharded")
        check(ranks[0][name]["digest"] == ranks[1][name]["digest"],
              f"spatial (b) {name}: the ranks' masters differ")
        print(f"  spatial (b) {name} 64^3 f32, sp [2], 2 gloo ranks on '{card}' vs one process "
              f"at batch 2: loss |diff| {gaps['loss']:.2e}, gradient gap summed "
              f"{gaps['summed']:.3e} (worst {gaps['worst']} {gaps['worst_gap']:.2e}), "
              f"parameters within W5 (excess {gaps['w5_excess']:.2e}); masters bitwise equal")
    for name in SP_TP_CASES:
        gaps = check_ddp_step(ranks[0][name], refs["C-Swin-UNETR fs 24"], f"spatial (b) {name}")
        check(ranks[0][name]["digest"] == ranks[1][name]["digest"]
              and ranks[0][name]["placed"]["fsdp"] > 0,
              f"spatial (b) {name}: the ranks' masters differ or nothing is placed")
        print(f"  spatial (b) C-Swin-UNETR fs 24 64^3 f32, {name}, 2 gloo ranks on '{card}' vs "
              f"one process at batch 2: loss |diff| {gaps['loss']:.2e}, gradient gap summed "
              f"{gaps['summed']:.3e} (worst {gaps['worst']} {gaps['worst_gap']:.2e}), "
              f"parameters within W5 (excess {gaps['w5_excess']:.2e}); masters bitwise equal; "
              f"{ranks[0][name]['placed']['fsdp']} TP leaves gathered a step; masters + "
              f"moments a rank {ranks[0][name]['state_bytes']} B vs one process "
              f"{refs['C-Swin-UNETR fs 24']['state_bytes']} B")
    lead = ranks[0]["flagship"]
    gap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(lead["losses"], one_losses))
    check(gap <= 1e-3, f"spatial (c): losses {lead['losses']} vs one process {one_losses}")
    excess = _w5_excess(lead["params"], one["params"])
    check(excess <= 0.0, f"spatial (c): parameters exceed W5 by {excess:.3e}")
    check(all(r["flagship"]["losses"] == lead["losses"] and r["flagship"]["digest"] ==
              lead["digest"] and r["flagship"]["final_digest"] == lead["final_digest"]
              for r in ranks), "spatial (c): the ranks' losses or masters differ")
    want = sp_launches(2)
    by_name = {k: want[k] + want.get(m, 0) for k, m in (
        ("K1", "K1 moments"), ("K1 fold", "K1 fold moments"), ("K4", "K4 halo"),
        ("K2", None), ("K3", None), ("K5", None))}
    for r, res in enumerate(ranks):
        rec = res["flagship"]
        totals = {k: SP_STEPS * v for k, v in want.items()}
        # by name a K4 call is its conv kernel; the FMA kernel's split-K
        # reduce (the 6-plane slabs at 12^3) is a second kernel of the call
        convs = sum("miseg_k4_conv" in nm for nm in rec["k4_kernels"])
        check(rec["sp_top"] == (96, 96) and rec["launch_totals"] == totals
              and {**rec["profiled"], "K4": convs} == by_name,
              f"spatial (c) rank {r}: patch {rec['sp_top']}, {SP_STEPS} steps launched "
              f"{rec['launch_totals']}, the profiled step {rec['profiled']}; want {totals} and "
              f"{by_name}")
        paths = Counter(n.split("<")[0].split("::")[-1] for n in rec["k4_kernels"])
        print(f"  spatial (c) flagship fs 48 96^3 bf16, sp [2] rank {r} (batch 1, a 48-plane "
              f"slab) on '{card}': launches a step {want} (counted; by name {rec['profiled']});"
              f" K4 kernels of the profiled step {dict(paths)}; collectives a step "
              f"{rec['collectives']}; step ms by events {[round(v, 2) for v in rec['ms']]}, "
              f"device busy {rec['busy_ms']:.2f} ms of the profiled step, peak memory "
              f"{gib(rec['peak'])} ({rec['peak']} B)")
    fl = ranks[0]["fsdp flagship"]
    fgap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(fl["losses"], one_losses))
    check(fgap <= 1e-3, f"spatial (d): losses {fl['losses']} vs one process {one_losses}")
    fexcess = _w5_excess(fl["params"], one["params"])
    check(fexcess <= 0.0, f"spatial (d): parameters exceed W5 by {fexcess:.3e}")
    check(all(r["fsdp flagship"]["losses"] == fl["losses"] and r["fsdp flagship"]["digest"] ==
              fl["digest"] and r["fsdp flagship"]["final_digest"] == fl["final_digest"]
              for r in ranks), "spatial (d): the ranks' losses or gathered masters differ")
    for r, res in enumerate(ranks):
        rec = res["fsdp flagship"]
        totals = {k: SP_STEPS * v for k, v in want.items()}
        check(rec["sp_top"] == (96, 96) and rec["axes"] == ["sp"]
              and rec["launch_totals"] == totals,
              f"spatial (d) rank {r}: patch {rec['sp_top']}, FSDP axes {rec['axes']}, "
              f"{SP_STEPS} steps launched {rec['launch_totals']}; want {totals}")
        print(f"  spatial (d) flagship fs 48 96^3 bf16, sp [2] + FSDP on 'sp' rank {r} on "
              f"'{card}': launches a step {want}; step ms by events "
              f"{[round(v, 2) for v in rec['ms']]}; masters + moments a rank "
              f"{rec['state_bytes']} B against SP alone's {res['flagship']['state_bytes']} B "
              f"({rec['state_bytes'] / res['flagship']['state_bytes']:.1%}; "
              f"{rec['placed_elements']} of {rec['elements']} parameters sharded); peak memory "
              f"{gib(rec['peak'])} ({rec['peak']} B) against SP alone's "
              f"{gib(res['flagship']['peak'])}; {rec['seconds']:.1f} s for (d)")
    print(f"  spatial (d) flagship + FSDP: losses {[round(v, 6) for v in fl['losses']]} vs one "
          f"process {[round(v, 6) for v in one_losses]} (max relative gap {fgap:.2e}); "
          f"parameters after the first step within W5 (excess {fexcess:.2e}); the ranks' "
          f"gathered masters bitwise equal")
    print(f"  spatial (c) flagship: losses {[round(v, 6) for v in lead['losses']]} vs one "
          f"process {[round(v, 6) for v in one_losses]} (max relative gap {gap:.2e}); "
          f"parameters after the first step within W5 (excess {excess:.2e}); the ranks' masters "
          f"bitwise equal; one process at batch 1 on '{card}' (beside the ranks): step ms "
          f"{[round(v, 2) for v in one_ms]}, peak memory {gib(one_peak)} ({one_peak} B); a "
          f"rank's peak {ranks[0]['flagship']['peak'] / one_peak:.1%} of it")
    model_launches = {}
    for name, (model, kind) in SP_MODELS.items():
        ref, lead = model_refs[name], ranks[0][name]
        where = f"spatial (e) {name}"
        mgap = max(abs(x - y) / (1 + abs(y)) for x, y in zip(lead["losses"], ref["losses"]))
        check(mgap <= 1e-3, f"{where}: losses {lead['losses']} vs one process {ref['losses']}")
        mexcess = _w5_excess(lead["params"], ref["params"])
        check(mexcess <= 0.0, f"{where}: parameters exceed W5 by {mexcess:.3e}")
        check(all(r[name]["losses"] == lead["losses"] and r[name]["digest"] == lead["digest"]
                  and r[name]["final_digest"] == lead["final_digest"] for r in ranks),
              f"{where}: the ranks' losses or masters differ")
        mwant = model_launches[name] = sp_launches(2, model=kind)
        mby_name = {k: mwant[k] + mwant.get(m, 0) for k, m in (
            ("K1", "K1 moments"), ("K1 fold", "K1 fold moments"), ("K4", "K4 halo"),
            ("K2", None), ("K3", None), ("K5", None))}
        top = (model["roi_x"], model["roi_y"])
        for r, res in enumerate(ranks):
            rec = res[name]
            totals = {k: SP_STEPS * v for k, v in mwant.items()}
            convs = sum("miseg_k4_conv" in nm for nm in rec["k4_kernels"])
            check(rec["sp_top"] == top and rec["launch_totals"] == totals
                  and {**rec["profiled"], "K4": convs} == mby_name,
                  f"{where} rank {r}: patch {rec['sp_top']}, {SP_STEPS} steps launched "
                  f"{rec['launch_totals']}, the profiled step {rec['profiled']}; want {totals} "
                  f"and {mby_name}")
            paths = Counter(n.split("<")[0].split("::")[-1] for n in rec["k4_kernels"])
            print(f"  {where} {top} bf16, sp [2] rank {r} (batch 1) on '{card}': launches a "
                  f"step {mwant} (counted; by name {rec['profiled']}); K4 kernels of the "
                  f"profiled step {dict(paths)}; collectives a step {rec['collectives']}; step "
                  f"ms by events {[round(v, 2) for v in rec['ms']]}, device busy "
                  f"{rec['busy_ms']:.2f} ms of the profiled step, peak memory "
                  f"{gib(rec['peak'])} ({rec['peak']} B); {rec['seconds']:.1f} s for (e) "
                  f"({', '.join(f'{k} {v:.1f}' for k, v in rec['parts_s'].items())} s)")
        print(f"  {where}: losses {[round(v, 6) for v in lead['losses']]} vs one process "
              f"{[round(v, 6) for v in ref['losses']]} (max relative gap {mgap:.2e}); "
              f"parameters after the first step within W5 (excess {mexcess:.2e}); the ranks' "
              f"masters bitwise equal; one process at batch 1 on '{card}' (beside the ranks): "
              f"step ms {[round(v, 2) for v in ref['ms']]}, peak memory {gib(ref['peak'])} "
              f"({ref['peak']} B); a rank's peak {lead['peak'] / ref['peak']:.1%} of it")
    tmp.cleanup()
    print(f"spatial: K4's D-halo mode and K1's and the fold's moments modes match their plain "
          f"versions; the line [2] steps as one process, the flagship, C-UNETR, UNetVanilla "
          f"and the 2-D flagship with every kernel and mode ({t_kernels:.1f} s of kernels, "
          f"{t_ranks:.1f} s of ranks; phase {time.perf_counter() - t0:.1f} s)")
    return {"rows": rows, "launches": want, "models": model_launches,
            "fsdp_launches": {k: v // SP_STEPS for k, v in fl["launch_totals"].items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py needs a CUDA card",
              file=sys.stderr)
        return 1
    # every f32 comparison is against full-precision f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    seconds: dict[str, float] = {}

    def timed(name: str, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    prepare_inputs()   # beside the kernels' build: CPU work of later phases
    card = timed("device", phase_device)
    mem_bw, bf16_flops, peak_name = card_peaks(card)
    print(f"  bounds use {peak_name} peaks: {mem_bw / 1e12:.2f} TB/s, "
          f"{bf16_flops / 1e12:.0f} TFLOP/s bf16")
    rows = timed("kernels", phase_kernels, dev, mem_bw, bf16_flops)
    timed("model", phase_model, dev)
    launches, replay224 = timed("serve", phase_serve, dev)
    http_launches = timed("serve_http", phase_serve_http, dev, card)
    train = timed("train", phase_train, dev, card)
    fit = timed("fit", phase_fit, dev, card)
    unetr = timed("unetr", phase_unetr, dev, card, mem_bw, bf16_flops)
    unet = timed("unet", phase_unet, dev, card, mem_bw)
    finetune = timed("finetune", phase_finetune, dev, card)
    tune = timed("tune", phase_tune, dev, card, mem_bw, bf16_flops)
    two_d = timed("two_d", phase_two_d, dev, card, mem_bw, bf16_flops)
    ddp = timed("ddp", phase_ddp, dev, card)
    mesh = timed("mesh", phase_mesh, dev, card)
    pipeline = timed("pipeline", phase_pipeline, dev, card)
    spatial = timed("spatial", phase_spatial, dev, card, mem_bw, bf16_flops)
    _prepared()
    print(f"phase seconds: {json.dumps(seconds)}; the fits' data sets and the HTTP scans "
          f"written in {_PREPARED['seconds']:.1f} s beside the kernels' build")
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
    # the registered op each kernel is in an exported program
    OPS = {"K1": "miseg::channel_scale_shift", "K1 fold": "miseg::conv3_norm_columns",
           "K2": "miseg::apply_scale_shift", "K3": "miseg::apply_norm2_act",
           "K4": "miseg::conv3_norm_columns", "K5": "miseg::window_attention"}
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
        check(http_launches[key] > 0, f"{key} was never launched over HTTP")
        check(train[key] > 0, f"{key} was never launched in the train step")
        check(fit["train"][key] > 0 and fit["eval"][key] > 0,
              f"{key} was never launched in the fit's train steps or its evaluations")
        on_unetr = UNETR_PER_WINDOW[key] > 0   # C-UNETR has no window attention
        check(on_unetr == (unetr["window"][key] > 0) == (unetr["step"][key] > 0)
              == (unetr["fit"]["train"][key] > 0) == (unetr["fit"]["eval"][key] > 0),
              f"{key}: C-UNETR's window, step, fit steps and evaluations launched it "
              f"{unetr['window'][key]}, {unetr['step'][key]}, {unetr['fit']['train'][key]}, "
              f"{unetr['fit']['eval'][key]} times; want {'> 0' if on_unetr else '0'}")
        # the UNets' norms are K1 + K2 alone: no K4 (so no fold), K3 or K5
        unet_counts = [*(unet["window"][m][key] for m in ("C-UNet", "unet_vanilla")),
                       *(unet["step"][m][key] for m in ("C-UNet", "unet_vanilla")),
                       unet["fit"]["train"][key], unet["fit"]["eval"][key]]
        on_unet = key in ("K1", "K2")
        check(all((n > 0) == on_unet for n in unet_counts),
              f"{key}: the UNets' windows, steps, fit steps and evaluations launched it "
              f"{unet_counts} times; want {'> 0' if on_unet else '0'}")
        # fine-tuning with recompute: every kernel in the forward and the backward
        check(finetune["train"][key] > 0 and finetune["eval"][key] > 0
              and RECOMPUTE_PER_STEP[key] > 0,
              f"{key} was never launched in the fine-tune's steps, backward or evaluations")
        check(tune["study"][key] > 0, f"{key} was never launched in the tune study")
        on_2d = TWO_D_PER_WINDOW[key] > 0   # 2-D: K1, K2 and K5; no K3, no K4
        check(on_2d == (two_d["serve"][key] > 0) == (two_d["step"][key] > 0),
              f"{key}: the 2-D slice and step launched it {two_d['serve'][key]} and "
              f"{two_d['step'][key]} times; want {'> 0' if on_2d else '0'}")
        check(ddp[key] > 0 and ddp["fanout"][key] > 0,
              f"{key} was never launched in the data-parallel step or the fanned-out "
              "evaluation")
        check(mesh[key] > 0, f"{key} was never launched in the FSDP step")
        check(spatial["launches"][key] > 0,
              f"{key} was never launched in the spatially partitioned step")
        # a kernel counts with its spatial mode on the partitioned legs
        mode = {"K1": "K1 moments", "K1 fold": "K1 fold moments", "K4": "K4 halo"}.get(key)
        on_pp = {leg: sum(stage[key] + stage.get(mode, 0) for stage in by_stage)
                 for leg, by_stage in pipeline.items()}
        check(on_pp["pp4"] > 0 and on_pp["pp4 fsdp"] > 0
              and on_pp["flagship sp x tp [1, 2, 2]"] > 0
              and (on_pp["pp2"] > 0) == (on_pp["C-UNETR sp x pp [1, 2, 2]"] > 0)
              == (UNETR_PER_WINDOW[key] > 0),
              f"{key}: the pipeline steps' stages launched it (with its spatial mode) "
              f"{on_pp} times")
        search = {"launches_study": tune["study"][key]}
        if key in tune["rows"]:
            search["search_space_shapes"] = tune["rows"][key]
        if key == "K4":
            search["kernels_per_bf16_window"] = tune["k4_by_pair"]
        kernels.append({"name": f"{key} {name}", "route": route, "source": source,
                        "replaces": replaces, "op": OPS[key], "launches": launches[key],
                        **rows[key],
                        "serve_captured": {"kernels_per_224_replay": replay224[key]},
                        "train": {"launches_per_step": train[key],
                                  "backward": backward[key]},
                        "fit": {"launches_train_steps": fit["train"][key],
                                "launches_evaluate": fit["eval"][key]},
                        "unetr": {"launches_per_window": unetr["window"][key],
                                  "launches_per_step": unetr["step"][key],
                                  "fit_launches_train_steps": unetr["fit"]["train"][key],
                                  "fit_launches_evaluate": unetr["fit"]["eval"][key]},
                        "unet": {"cunet_launches_per_window": unet["window"]["C-UNet"][key],
                                 "cunet_launches_per_step": unet["step"]["C-UNet"][key],
                                 "vanilla_launches_per_window":
                                     unet["window"]["unet_vanilla"][key],
                                 "vanilla_launches_per_step": unet["step"]["unet_vanilla"][key],
                                 "vanilla_fit_launches_train_steps": unet["fit"]["train"][key],
                                 "vanilla_fit_launches_evaluate": unet["fit"]["eval"][key]},
                        "finetune": {"launches_forward_per_step": PER_WINDOW[key],
                                     "launches_recompute_per_step": RECOMPUTE_PER_STEP[key],
                                     "fit_launches_train_steps": finetune["train"][key],
                                     "fit_launches_evaluate": finetune["eval"][key]},
                        "tune": search,
                        "two_d": {"launches_per_window": TWO_D_PER_WINDOW[key],
                                  "launches_512_slice": two_d["serve"][key],
                                  "launches_per_step": two_d["step"][key],
                                  **({"shape_2d": two_d["rows"][key]}
                                     if key in two_d["rows"] else {}),
                                  **({"shape_2d_stage4": two_d["rows"]["K5 stage 4"]}
                                     if key == "K5" else {})},
                        "ddp": {"launches_per_wrapped_step": ddp[key],
                                "launches_fanned_out_volume_a_rank": ddp["fanout"][key]},
                        "mesh": {"launches_per_fsdp_step": mesh[key]},
                        "pipeline": {"swin_1x4_launches_per_step_by_stage":
                                         [stage[key] for stage in pipeline["pp4"]],
                                     "swin_1x4_fsdp_pp_launches_per_step_by_stage":
                                         [stage[key] for stage in pipeline["pp4 fsdp"]],
                                     "unetr_1x2_launches_per_step_by_stage":
                                         [stage[key] for stage in pipeline["pp2"]],
                                     "unetr_sp_x_pp_1x2x2_launches_per_step_by_stage":
                                         [stage[key] for stage in
                                          pipeline["C-UNETR sp x pp [1, 2, 2]"]],
                                     "swin_sp_x_tp_1x2x2_launches_per_step_a_rank":
                                         pipeline["flagship sp x tp [1, 2, 2]"][0][key]},
                        "spatial": {"launches_per_sp2_step": spatial["launches"][key],
                                    "launches_per_sp2_fsdp_step":
                                        spatial["fsdp_launches"][key],
                                    "launches_per_sp2_step_by_model":
                                        {m: c[key] for m, c in spatial["models"].items()}}})
    # the modes of spatial partitioning: the same kernels, launched (and
    # counted) apart on the partitioned step, with rows of their own
    modes = {
        "K4 halo": ("fused_conv.conv3_halo_moments (D-halo mode)", "fused_conv.cu",
                    "miseg_tpu/ops/pallas/fused_conv.py:49", "miseg::conv3_halo_moments"),
        "K1 moments": ("fused_norm.channel_moments (moments mode)", "fused_norm.cu",
                       "miseg_tpu/ops/pallas/fused_norm.py:78", None),
        "K1 fold moments": ("fused_norm.fold_launch(moments=True), after K4's D-halo mode",
                            "fused_norm.cu", "miseg_tpu/ops/pallas/fused_norm.py:78",
                            "miseg::conv3_halo_moments"),
    }
    for key, (name, source, replaces, op) in modes.items():
        n = spatial["launches"][key]
        check(n > 0, f"{key} was never launched in the spatially partitioned step")
        kernels.append({"name": f"{key} {name}", "route": "cuda",
                        "source": f"miseg_tpu_torch/ops/kernels/csrc/{source}",
                        "replaces": replaces, "op": op, "launches": SP_STEPS * n,
                        **spatial["rows"][key],
                        "spatial": {"launches_per_sp2_step": n,
                                    "launches_per_sp2_fsdp_step":
                                        spatial["fsdp_launches"][key],
                                    "launches_per_sp2_step_by_model":
                                        {m: c[key] for m, c in spatial["models"].items()}},
                        "pipeline": {"unetr_sp_x_pp_1x2x2_launches_per_step_by_stage":
                                         [stage[key] for stage in
                                          pipeline["C-UNETR sp x pp [1, 2, 2]"]],
                                     "swin_sp_x_tp_1x2x2_launches_per_step_a_rank":
                                         pipeline["flagship sp x tp [1, 2, 2]"][0][key]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["_ddp_rank"]:   # one rank of phase_ddp, started by it
        sys.exit(ddp_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                          sys.argv[6]))
    sys.exit(main())
