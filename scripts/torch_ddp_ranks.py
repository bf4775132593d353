"""Data parallelism over N ranks started by `torchrun`, against one process
on the same global batch; with `--launch N`, the whole N-card recipe.

    torchrun --standalone --nproc_per_node=N scripts/torch_ddp_ranks.py \
        [--device cpu] [--size 96] [--legs NAME ...]
    python scripts/torch_ddp_ranks.py --launch N [--size 96] [--legs NAME ...] \
        [--runs RUN ...]
    torchrun --standalone --nproc_per_node=N scripts/torch_ddp_ranks.py --fit \
        CLI_TRAIN_FLAGS ...

Under `torchrun`, each rank joins the group that
`parallel.init_process_group` sets up from torchrun's environment (NCCL on
the card, `cuda:LOCAL_RANK`; gloo with `--device cpu`), and takes its
slice of a seeded global batch of N volumes (`--size`^3, one a rank):
  * the batch-norm UNetVanilla at the README recipe in f32
    (`chip_smoke.VANILLA_BN`; batch norm's statistics cross the ranks),
    one AdamW step through `Trainer.train_step`: after the ranks,
    rank 0 leaves the group and runs the same step in one process on the
    whole batch, held to it by `chip_smoke.check_ddp_step` (the loss, the
    gradients leaf by leaf, the W5 bound, the running statistics), and
    every rank must hold rank 0's parameters bitwise;
  * on the card, the flagship C-Swin-UNETR in bf16 (`chip_smoke.FLAGSHIP`):
    three steps, the ranks' step time by CUDA events (median after a
    warm-up step) beside one process's at batch 1 (rank 0, after the
    group), so the difference is what the gradient all-reduce over the
    ranks costs;
  * FSDP, tensor and pipeline parallelism (`MESH_LEGS`, at 4 ranks: FSDP
    `[4]`, TP `[2, 2]` and TP + FSDP `[2, 2]` over ("data", "model"); GPipe
    over ("data", "pp"), the flagship's swin stages on `[1, 4]` and
    C-UNETR's ViT on `[2, 2]`, two microbatches; GPipe beside FSDP, the
    flagship on `[1, 4]` with FSDP on "pp" and C-UNETR on `[2, 2]` with
    FSDP on "data", and beside TP, C-UNETR on ("data", "model", "pp") `[1,
    2, 2]` with TP and with TP + FSDP on "model"): one f32 step of the leg's
    small model (`chip_smoke.MESH_SMALL`, the flagship's model at fs 24,
    64^3, or C-UNETR at 64^3) on a global batch of one volume a "data"
    coordinate (two under GPipe), held after the group to rank 0's one
    process on that batch by `chip_smoke.check_ddp_step` (loss, gathered
    gradients leaf by leaf, W5); and on the card three bf16 steps of the
    leg's full-width model (the flagship, or C-UNETR), each rank's step
    ms (median after a warm-up step) and bytes of f32 masters plus AdamW
    moments and peak memory from the first step, and under GPipe each
    rank's device busy ms in one profiled step, beside one process's step
    at the same batch and GPipe's bubble, (S - 1) / (M + S - 1);
  * spatial partitioning (`MESH_LEGS` "sp [4]" and "data x sp [2, 2]",
    `--spatial_shard` over ("sp",) or ("data", "sp")), and beside FSDP
    ("sp + fsdp [4]" with `fsdp_axis="sp"`, "data x sp + fsdp [2, 2]" with
    `fsdp_axis="data"`): the same f32 step held to one process, and on
    the card the flagship's bf16 step ms, peak memory and bytes of masters
    and moments a rank beside one process's; on `[4]` also at 192^3
    (`SP_LARGE`) against one process at 192^3 (its peak, or that it does
    not fit); "unetr sp [4]" the same for C-UNETR (its small model at
    64^3 f32, its full-width step at `--size`^3); beside the pipeline and
    tensor parallelism ("unetr sp x pp [2, 2]" on ("sp", "pp"), two
    microbatches; "sp x tp [2, 2]" on ("sp", "model")) and tensor
    parallelism over "data" ("tp over data [4]", one volume a rank, its
    leaves gathered a step as FSDP's), the same.
Rank 0 prints one line each and `ok`; any failed check raises.  `--legs`
runs only the named legs of `MESH_LEGS` (default: all).

`--fit` (under torchrun) runs `cli.train.main` on the flags after it and
prints, from rank 0, a line `FIT {json}` of every rank's seconds of each
validation and of each epoch and the windows it predicted of each
evaluated volume (`Trainer.history`): under a mesh the window groups fan
out over its first axis.

`--launch N` (not under torchrun) runs, each under `torchrun --standalone
--nproc_per_node=N` with its own time limit: this script; `cli.train`
on the flagship for 2 epochs over a synthetic dataset (4 train volumes of
128x128x112 a modality); `cli.train --fsdp` for 1 epoch, and with N = 4
`cli.train --pipeline_parallel --mesh_shape 1 4 --mesh_axes data pp`
(batch 2, two microbatches), the same with `--fsdp --fsdp_axis pp` (run
"pp_fsdp") and `cli.train --spatial_shard --mesh_shape 4 --mesh_axes sp`
for 1 epoch each, whose `last.ckpt`s must hold the data-parallel run's
names and whole shapes; with N = 4 (run "sp_fsdp")
one epoch of `cli.train --spatial_shard --fsdp --fsdp_axis sp
--mesh_shape 4 --mesh_axes sp` and of one process through `--fit`, each
rank's seconds a validation and windows a volume beside one process's,
its `last.ckpt` holding one process's names and whole shapes;
`cli.tune` for 2 one-epoch trials over the same data.  `--runs` takes
only the named ones of "train", "fsdp", "pp", "pp_fsdp", "sp",
"sp_fsdp" and "tune" ("train" writes the checkpoint "fsdp", "pp",
"pp_fsdp" and "sp" are held to; `--runs` alone: none).  Each must exit 0,
`cli.train` leave `best.ckpt`, `last.ckpt` and its metrics, and
`cli.tune` its journal; the outputs go to
`chiprun_out/ddp<N>_*.txt`, and each step's seconds are printed with the
card's name and power limit.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from miseg_tpu_torch import parallel  # noqa: E402
from miseg_tpu_torch.config import Config  # noqa: E402
from miseg_tpu_torch.train.engine import Trainer  # noqa: E402


def batches(cfg: Config, world: int, size: int, steps: int, device) -> list[dict]:
    gen = torch.Generator().manual_seed(9)
    shape = (world, size, size, size)
    return [{"image": torch.randn((*shape, 1), generator=gen).to(device),
             "label": torch.randint(0, cfg.out_channels, shape, generator=gen).to(device),
             "modality": (torch.arange(world) % 2).to(torch.int32).to(device)}
            for _ in range(steps)]


def run(cfg: Config, device, data: list[dict], rank: int | None):
    """`len(data)` steps on `rank`'s sample of each batch (None: all of it);
    (state, the last loss, CUDA-event ms a step or [])."""
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    ms, loss = [], None
    for batch in data:
        if rank is not None:
            batch = {k: v[rank:rank + 1] for k, v in batch.items()}
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        state, loss = trainer.train_step(state, batch)
        if device.type == "cuda":
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    return state, float(loss), ms


def snapshot(state, loss: float) -> dict:
    return {"loss": loss,
            "params": {n: p.detach().cpu() for n, p in state.params.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in state.params.items()},
            "buffers": {n: b.cpu() for n, b in state.buffers.items()}}


MESH_2X2 = dict(mesh_shape=[2, 2], mesh_axes=["data", "model"])
SP_4 = dict(spatial_shard=True, mesh_shape=[4], mesh_axes=["sp"])
PP_3D = {**cs.PP_UNETR, "mesh_shape": [1, 2, 2], "mesh_axes": ["data", "model", "pp"]}
# name -> (the parallelism fields, the f32 model, the full-width bf16 model,
# volumes a "data" coordinate)
MESH_LEGS = {"fsdp [N]": (dict(fsdp=True), cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "tp [2, 2]": (dict(MESH_2X2, tensor_parallel=True), cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "tp + fsdp [2, 2]": (dict(MESH_2X2, tensor_parallel=True, fsdp=True,
                                       fsdp_axis="model"), cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "pp [1, 4]": (cs.PP_SWIN, cs.MESH_SMALL, cs.FLAGSHIP, 2),
             "pp [2, 2]": ({**cs.PP_UNETR, "mesh_shape": [2, 2]}, cs.PP_UNETR_SMALL, cs.UNETR,
                           2),
             "pp + fsdp [1, 4]": (cs.PP_FSDP, cs.MESH_SMALL, cs.FLAGSHIP, 2),
             "data x pp + fsdp [2, 2]": ({**cs.PP_UNETR, "mesh_shape": [2, 2], "fsdp": True},
                                         cs.PP_UNETR_SMALL, cs.UNETR, 2),
             "pp x tp [1, 2, 2]": ({**PP_3D, "tensor_parallel": True}, cs.PP_UNETR_SMALL,
                                   cs.UNETR, 2),
             "pp x tp + fsdp [1, 2, 2]": ({**PP_3D, "tensor_parallel": True, "fsdp": True,
                                          "fsdp_axis": "model"}, cs.PP_UNETR_SMALL, cs.UNETR,
                                         2),
             "sp [4]": (SP_4, cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "data x sp [2, 2]": (dict(spatial_shard=True, mesh_shape=[2, 2],
                                       mesh_axes=["data", "sp"]), cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "sp + fsdp [4]": (dict(spatial_shard=True, mesh_shape=[4], mesh_axes=["sp"],
                                    fsdp=True, fsdp_axis="sp"), cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "data x sp + fsdp [2, 2]": (dict(spatial_shard=True, mesh_shape=[2, 2],
                                              mesh_axes=["data", "sp"], fsdp=True,
                                              fsdp_axis="data"), cs.MESH_SMALL, cs.FLAGSHIP,
                                         1),
             "unetr sp [4]": (SP_4, cs.PP_UNETR_SMALL, cs.UNETR, 1),
             # spatial partitioning beside the pipeline and TP on ("sp", "pp" /
             # "model") meshes (the spatial line places the batch), and TP
             # over "data" (its leaves gathered a step, as FSDP's)
             "unetr sp x pp [2, 2]": ({**cs.PP_UNETR, "mesh_shape": [2, 2],
                                       "mesh_axes": ["sp", "pp"], "spatial_shard": True},
                                      cs.PP_UNETR_SMALL, cs.UNETR, 2),
             "sp x tp [2, 2]": (dict(mesh_shape=[2, 2], mesh_axes=["sp", "model"],
                                     spatial_shard=True, tensor_parallel=True),
                                cs.MESH_SMALL, cs.FLAGSHIP, 1),
             "tp over data [4]": (dict(mesh_shape=[4], mesh_axes=["data"],
                                       tensor_parallel=True, tp_axis="data"),
                                  cs.MESH_SMALL, cs.FLAGSHIP, 1)}
# the spatial legs that also run the flagship at this patch size
SP_LARGE = (("sp [4]", "sp + fsdp [4]"), 192)


def flagship_steps(par: dict, size: int, data: int, device,
                   model: dict = cs.FLAGSHIP) -> tuple[list, int, int]:
    """Three bf16 steps of `model` (the flagship unless given) at `size`^3
    under `par`, on this rank's share of a batch of `data` volumes:
    (CUDA-event ms a step, peak memory, bytes of f32 masters and AdamW
    moments this rank holds)."""
    big = {**model, "roi_x": size, "roi_y": size, "roi_z": size}
    fdata = [cs._share(b) for b in batches(Config(**big), data, size, 3, device)]
    trainer = Trainer(Config(**big, **par), device=device)
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for batch in fdata:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = trainer.train_step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, torch.cuda.max_memory_allocated(), trainer.state_bytes(state)


def one_process_large(size: int, device, model: dict = cs.FLAGSHIP) -> str:
    """One process's bf16 step of `model` (the flagship unless given) at
    `size`^3, batch 1: its step ms and peak memory, or that it does not fit
    on the card."""
    try:
        ms, peak, state_bytes = flagship_steps({}, size, 1, device, model)
    except torch.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return f"does not fit ({str(e).splitlines()[0][:160]})"
    return (f"step ms {[round(v, 2) for v in ms]}, peak memory {peak} B, masters + moments "
            f"{state_bytes} B")



def mesh_legs(device, world: int, size: int, legs=None) -> dict:
    """Each of `MESH_LEGS` (or of the names `legs`) this rank takes part in
    (those with a mesh shape need as many ranks): the f32 step of its small
    model (a
    `chip_smoke._mesh_record`, on rank 0) and, on the card, its full-width
    model's bf16 step ms and state bytes of every rank (under GPipe also
    its device busy ms in one profiled step)."""
    out = {}
    roi = dict(roi_x=size, roi_y=size, roi_z=size)
    for name, (par, small, big, per) in MESH_LEGS.items():
        if par.get("mesh_shape") and math.prod(par["mesh_shape"]) != world:
            continue
        if legs is not None and name not in legs:
            continue
        trainer = Trainer(Config(**small, **par), device=device)
        data = trainer.mesh.size("data")
        state = trainer.init_state()
        state, loss = trainer.train_step(state, cs._share(cs._mesh_batch(device, small,
                                                                          data * per)))
        rec = {"small": cs._mesh_record(trainer, state, loss), "data": data}
        del trainer, state
        if device.type == "cuda":
            big = {**big, **roi}
            fdata = [cs._share(b) for b in batches(Config(**big), data * per, size, 3, device)]
            trainer = Trainer(Config(**big, **par), device=device)
            state = trainer.init_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for batch in fdata:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                state, _ = trainer.train_step(state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            busy = None
            if trainer._pp_active():
                events = cs.profiled(lambda: trainer.train_step(state, fdata[-1]),
                                     lambda ev: True, attempts=1,
                                     lead=lambda: trainer.train_step(state, fdata[-1]))
                busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
            per_rank = [None] * world
            dist.all_gather_object(per_rank, (ms, trainer.state_bytes(state), busy,
                                              torch.cuda.max_memory_allocated()))
            rec["big"] = per_rank
            rec["big_placed"] = cs._mesh_record(trainer, state, 0.0)["placed_elements"]
            del trainer, state
            if par.get("spatial_shard"):
                peaks = [None] * world
                dist.all_gather_object(peaks, flagship_steps(par, size, data * per, device,
                                                             big))
                rec["sp_peaks"] = {size: peaks}
                if name in SP_LARGE[0]:
                    large = [None] * world
                    dist.all_gather_object(large, flagship_steps(par, SP_LARGE[1], data * per,
                                                                 device))
                    rec["sp_peaks"][SP_LARGE[1]] = large
        out[name] = rec
    return out


def ranks_main(args) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.init_process_group(args.device)
    rank, world = parallel.host_shard_info()
    if world < 2:
        raise SystemExit("run under torchrun with --nproc_per_node >= 2")
    size = args.size
    roi = dict(roi_x=size, roi_y=size, roi_z=size)

    vanilla = Config(**{**cs.VANILLA_BN, **roi})
    data = batches(vanilla, world, size, 1, device)
    state, loss, _ = run(vanilla, device, data, rank)
    ranks = snapshot(state, loss)
    flat = torch.cat([p.reshape(-1) for p in state.params.values()])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    same = all(torch.equal(g, gathered[0]) for g in gathered)

    flagship = Config(**{**cs.FLAGSHIP, **roi})
    if device.type == "cuda":
        fdata = batches(flagship, world, size, 3, device)
        _, _, ranks_ms = run(flagship, device, fdata, rank)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    backend = dist.get_backend()
    legs = mesh_legs(device, world, size, args.legs)
    parallel.destroy_process_group()
    if rank != 0:
        return
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())

    # one process, the whole batch
    t0 = time.perf_counter()
    state, loss, _ = run(vanilla, device, data, None)
    one_s = time.perf_counter() - t0
    cs.check(same, "the ranks' parameters differ")
    gaps = cs.check_ddp_step(ranks, snapshot(state, loss), f"{world} ranks")
    print(f"{world} ranks ({backend}, '{card}') vs one process at batch {world}, batch-norm "
          f"UNetVanilla {size}^3 f32, one step: loss |diff| {gaps['loss']:.2e}, "
          f"gradient gap summed {gaps['summed']:.3e}, worst {gaps['worst']} "
          f"{gaps['worst_gap']:.2e}; parameters within W5 (excess {gaps['w5_excess']:.2e}); "
          f"{gaps['stats']} running statistics within rtol 1e-5 / atol 1e-6; every rank "
          f"equal; one process {one_s:.1f} s")
    if device.type == "cuda":
        _, _, one_ms = run(flagship, device, [{k: v[:1] for k, v in b.items()} for b in fdata],
                           None)
        r, o = statistics.median(ranks_ms[1:]), statistics.median(one_ms[1:])
        print(f"flagship {size}^3 bf16 step by CUDA events (median of 2 after a warm-up): "
              f"{world} ranks at batch 1 each (global {world}) {r:.2f} ms {ranks_ms}; one "
              f"process at batch 1 {o:.2f} ms {one_ms}; difference {r - o:+.2f} ms")
    held_legs(legs, device, size, card, one_ms if device.type == "cuda" else None,
              ranks_ms if device.type == "cuda" else None)
    print("ok")


def held_legs(legs: dict, device, size: int, card: str, one_ms, dp_ms) -> None:
    """Rank 0's one process against each of `mesh_legs`' results; the
    full-width step a rank beside data parallelism's (`dp_ms`, batch 1 a
    rank) and one process's at a data coordinate's batch (`one_ms` at
    batch 1; measured here at 2 for GPipe)."""
    for name, rec in legs.items():
        par, small, big, per = MESH_LEGS[name]
        trainer = Trainer(Config(**small), device=device)
        state = trainer.init_state()
        state, loss = trainer.train_step(state, cs._mesh_batch(device, small,
                                                              rec["data"] * per))
        want = cs._mesh_record(trainer, state, loss)
        del trainer, state
        gaps = cs.check_ddp_step(rec["small"], want, name)
        line = (f"{name} ({card}), {small['model_name']} fs {small['feature_size'][0]} "
                f"{small['roi_x']}^3 f32, global batch {rec['data'] * per}, placed "
                f"{rec['small']['placed']}: loss |diff| {gaps['loss']:.2e}, gradient gap "
                f"summed {gaps['summed']:.3e} (worst {gaps['worst']} {gaps['worst_gap']:.2e}), "
                f"parameters within W5 (excess {gaps['w5_excess']:.2e})")
        if "big" in rec:
            big = {**big, "roi_x": size, "roi_y": size, "roi_z": size}
            one = Trainer(Config(**big), device=device)
            one_state = one.init_state()
            one_bytes = one.state_bytes(one_state) * 3     # + AdamW's two moments
            base = statistics.median(one_ms[1:])
            if per > 1 or MESH_LEGS[name][2] is not cs.FLAGSHIP:
                _, _, base_ms = run(Config(**big), device, batches(Config(**big), per, size, 3,
                                                                    device), None)
                base = statistics.median(base_ms[1:])
            del one, one_state
            ms = [statistics.median(m[1:]) for m, *_ in rec["big"]]
            line += (f"; {big['model_name']} {size}^3 bf16 at batch {per} a data coordinate, "
                     f"step ms a rank (median of 2 after a warm-up) {[round(v, 2) for v in ms]} "
                     f"vs one process at batch {per} {base:.2f}")
            if per == 1 and MESH_LEGS[name][2] is cs.FLAGSHIP:
                line += f", data parallelism at batch 1 a rank {statistics.median(dp_ms[1:]):.2f}"
            if rec["big"][0][2] is not None:
                stages, m = par["mesh_shape"][1], par["pp_microbatches"]
                busy = [b for _, _, b, _ in rec["big"]]
                line += (f"; device busy a rank in a profiled step {[round(b, 2) for b in busy]}"
                         f" ms (idle {[f'{1 - b / t:.1%}' for b, t in zip(busy, ms)]}); "
                         f"GPipe's bubble (S - 1) / (M + S - 1) = {(stages - 1) / (m + stages - 1):.1%}")
            line += (f"; masters + AdamW moments a rank {[b for _, b, *_ in rec['big']]} bytes "
                     f"vs one process {one_bytes}; {rec['big_placed']} of {one_bytes // 12} "
                     f"parameters placed; peak memory a rank from the first step "
                     f"{[p for *_, p in rec['big']]} B")
        for side, runs in rec.get("sp_peaks", {}).items():
            one = (one_process_large(side, device, big) if side != size else
                   f"peak memory {flagship_steps({}, side, 1, device, big)[1]} B")
            line += (f"; {big['model_name']} {side}^3 bf16, step ms a rank "
                     f"{[[round(v, 2) for v in ms] for ms, _, _ in runs]}, peak memory a rank "
                     f"{[peak for _, peak, _ in runs]} B, masters + moments a rank "
                     f"{[b for _, _, b in runs]} B; one process at batch 1: {one}")
        print(line)


def _torchrun(n: int, args: list[str], log: Path, timeout: int) -> float:
    """`torchrun --standalone --nproc_per_node=n ARGS` into `log`; its
    seconds.  Fails when it exits with another code than 0.  A `FIT` line
    of the log (`--fit`) is printed whole."""
    t0 = time.perf_counter()
    with open(log, "w") as out:
        rc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={n}", *args], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT, timeout=timeout).returncode
    seconds = time.perf_counter() - t0
    lines = [ln for ln in log.read_text().splitlines() if "socket.cpp" not in ln]
    fit = [ln for ln in lines if ln.startswith("FIT ")]
    print(f"torchrun x{n} {' '.join(args[:2])}: rc {rc} in {seconds:.1f} s\n  "
          + "\n  ".join([*(ln[:300] for ln in lines[-6:] if ln not in fit), *fit]))
    cs.check(rc == 0, f"torchrun x{n} {' '.join(args[:2])} exited {rc} (log {log})")
    return seconds


def held_checkpoint(whole: Path, other: Path, what: str) -> None:
    """The checkpoint `cli.train <what>` wrote (its parameters and AdamW
    moments gathered to rank 0 under FSDP) holds every tensor of the
    data-parallel run's, under the same name and whole shape."""
    from miseg_tpu_torch.train.checkpoint import load_checkpoint

    def shapes(ck):
        moments = {(i, k): tuple(v.shape) for i, st in ck["opt_state"]["optimizer"]["state"]
                   .items() for k, v in st.items() if isinstance(v, torch.Tensor)}
        return {n: tuple(t.shape) for n, t in ck["params"].items()}, moments

    want, got = shapes(load_checkpoint(whole)), shapes(load_checkpoint(other))
    cs.check(got == want, f"cli.train {what}: {other} differs from {whole} in its names "
             "or shapes")
    print(f"cli.train {what} wrote {len(got[0])} parameters and {len(got[1])} moment tensors, "
          "whole, under the data-parallel checkpoint's names and shapes")


def fit_main(argv: list[str]) -> None:
    """Under torchrun: `cli.train.main` on the flags `argv`; rank 0 prints
    `FIT` and a JSON list of every rank's validation and epoch seconds and
    windows predicted a volume (validation volumes, then the test's)."""
    from miseg_tpu_torch.cli import parse_args
    from miseg_tpu_torch.cli import train as cli_train

    cfg, device = parse_args(argv)
    try:
        trainer, _, _ = cli_train.main(cfg, device=device)
        h = trainer.history
        mine = {"val_s": h["val_s"], "epoch_s": h["epoch_s"], "windows": h["eval_windows"],
                "mesh": list(trainer.mesh.shape)}
        per_rank = [mine]
        if dist.is_initialized():
            per_rank = [None] * dist.get_world_size()
            dist.all_gather_object(per_rank, mine)
            if dist.get_rank() != 0:
                return
        print("FIT " + json.dumps(per_rank))
    finally:
        parallel.destroy_process_group()


def launch_main(n: int, size: int, legs=None, runs=None) -> None:
    """The N-card recipe: the ranks check (its legs `legs`, default all),
    then `cli.train` and `cli.tune` under torchrun over a synthetic
    dataset (the runs `runs`, default all)."""
    from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
    from miseg_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    print(smi.strip())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    _torchrun(n, [str(Path(__file__).resolve()), "--size", str(size),
                  *(["--legs", *legs] if legs else [])], out / f"ddp{n}_ranks.txt", 600)

    def wanted(run: str) -> bool:
        return runs is None or run in runs

    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "syn"
        make_synthetic_dataset(data, shape=(128, 128, 112), num_classes=6, n_train=4,
                               n_val=1, n_test=1, spacing=(1.0, 1.0, 1.0), seed=9,
                               suffix=".nii")
        common = ["--model_name", "swin_unetr", "--out_channels", "6", "--feature_size", "48",
                  "--num_heads", "3", "--encoder_norm_name", "instance_cond",
                  "--vit_norm_name", "instance_cond", "--data_dirs", str(data), str(data),
                  "--json_lists", "CT.json", "MR.json", "--check_val_every_n_epoch", "1",
                  "--batch_size", "1", "--cache_num", "8", "--num_workers", "2",
                  "--default_root_dir", str(Path(tmp) / "runs")]
        run_dir = Path(tmp) / "runs" / "flagship"
        written = []
        if wanted("train"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.train", *common, "--max_epochs", "2",
                          "--experiment_name", "flagship"], out / f"ddp{n}_train.txt", 900)
            written = sorted(p.name for p in run_dir.iterdir())
            cs.check({"best.ckpt", "last.ckpt", "metrics.jsonl"} <= set(written),
                     f"cli.train wrote {written}")
        if wanted("fsdp"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.train", *common, "--max_epochs", "1",
                          "--fsdp", "--experiment_name", "fsdp"],
                      out / f"ddp{n}_train_fsdp.txt", 900)
            held_checkpoint(run_dir / "last.ckpt", Path(tmp) / "runs" / "fsdp" / "last.ckpt",
                            "--fsdp")
        if n == 4 and wanted("sp_fsdp"):
            script = str(Path(__file__).resolve())
            _torchrun(1, [script, "--fit", *common, "--max_epochs", "1",
                          "--experiment_name", "one"], out / f"ddp{n}_fit_one.txt", 900)
            _torchrun(n, [script, "--fit", *common, "--max_epochs", "1", "--spatial_shard",
                          "--fsdp", "--fsdp_axis", "sp", "--mesh_shape", "4", "--mesh_axes",
                          "sp", "--experiment_name", "sp_fsdp"],
                      out / f"ddp{n}_fit_sp_fsdp.txt", 900)
            held_checkpoint(Path(tmp) / "runs" / "one" / "last.ckpt",
                            Path(tmp) / "runs" / "sp_fsdp" / "last.ckpt",
                            "--spatial_shard --fsdp --fsdp_axis sp")
        if n == 4 and wanted("pp"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.train", *common, "--max_epochs", "1",
                          "--pipeline_parallel", "--mesh_shape", "1", "4", "--mesh_axes", "data",
                          "pp", "--batch_size", "2", "--experiment_name", "pp"],
                      out / f"ddp{n}_train_pp.txt", 900)
            held_checkpoint(run_dir / "last.ckpt", Path(tmp) / "runs" / "pp" / "last.ckpt",
                            "--pipeline_parallel")
        if n == 4 and wanted("pp_fsdp"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.train", *common, "--max_epochs", "1",
                          "--pipeline_parallel", "--fsdp", "--fsdp_axis", "pp", "--mesh_shape",
                          "1", "4", "--mesh_axes", "data", "pp", "--batch_size", "2",
                          "--experiment_name", "pp_fsdp"], out / f"ddp{n}_train_pp_fsdp.txt",
                      900)
            held_checkpoint(run_dir / "last.ckpt", Path(tmp) / "runs" / "pp_fsdp" / "last.ckpt",
                            "--pipeline_parallel --fsdp --fsdp_axis pp")
        if n == 4 and wanted("sp"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.train", *common, "--max_epochs", "1",
                          "--spatial_shard", "--mesh_shape", "4", "--mesh_axes", "sp",
                          "--experiment_name", "sp"], out / f"ddp{n}_train_sp.txt", 900)
            held_checkpoint(run_dir / "last.ckpt", Path(tmp) / "runs" / "sp" / "last.ckpt",
                            "--spatial_shard")
        if wanted("tune"):
            _torchrun(n, ["-m", "miseg_tpu_torch.cli.tune", *common, "--max_epochs", "1",
                          "--scheduler", "warmup_cosine", "--n_trials", "2",
                          "--study_name", "ddp", "--storage_name", "ddp"],
                      out / f"ddp{n}_tune.txt", 900)
            journal = Path(tmp) / "runs" / "ddp.journal.jsonl"
            cs.check(journal.exists(), f"cli.tune left no journal at {journal}")
            print(f"cli.train wrote {written}; cli.tune's journal holds "
                  f"{len(journal.read_text().splitlines())} lines")
    print("ok")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--launch", type=int, default=0,
                    help="run the N-card recipe (this script, cli.train, cli.tune) under "
                         "torchrun with N ranks")
    ap.add_argument("--legs", nargs="+", default=None, choices=list(MESH_LEGS),
                    help="the legs of MESH_LEGS to run (default: all)")
    ap.add_argument("--runs", nargs="*", default=None,
                    choices=["train", "fsdp", "pp", "pp_fsdp", "sp", "sp_fsdp", "tune"],
                    help="with --launch, the torchrun runs after the ranks (default: all; "
                         "none given: none)")
    args = ap.parse_args()
    if args.launch:
        if "WORLD_SIZE" in os.environ:
            raise SystemExit("--launch starts torchrun itself; run it with plain python")
        launch_main(args.launch, args.size, args.legs, args.runs)
    else:
        ranks_main(args)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fit"]:   # cli.train's flags follow
        fit_main(sys.argv[2:])
    else:
        main()
