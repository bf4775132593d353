"""A/B of the port's serving path on the card, between source trees.

    python scripts/torch_serve_ab.py --tree parent=_local/ab/parent --tree change=. \
        --order parent,change,change,parent --out chiprun_out/serve_ab.jsonl

Each run is a fresh process that imports `miseg_tpu_torch` from its tree
and serves the flagship C-Swin-UNETR (feature_size 48, heads 3, 96^3
ROI, 6 classes, bf16, gaussian blend at overlap 0.5, seeded random
weights) from a bundle that the tree's own `save_bundle` writes (its
defaults: no volume programs, so every request takes the window path).
It times on the card, through the public `load_bundle`, `ServedModel`
call and `ServedModel.predict`:

- start-up: `load_bundle`, and it plus the first 96^3 window's answer;
- windows: `--windows` back-to-back `served(window, [0])` calls, ms a
  window by CUDA events and by the host clock;
- a 224^3 request (64 windows) and a 308x308x192 one (108 windows, the
  preprocessed shape of the MR scan `chip_smoke.py` sends over HTTP),
  each twice, seconds and windows/s;
- the peak of `torch.cuda.max_memory_allocated`.

A tree whose `ServedModel` has `window_fn` (the uncaptured window program)
also gets the 224^3 request through the generic inferer over it, and a
second bundle with 224^3 as a volume program (`export_bundle`), whose
replays are timed beside the window path's.  The kernels build once: each
run copies the libraries the runs before it built into its own tree
(their file names carry their sources' hash).  Every run prints, and
appends to `--out`, one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FLAGSHIP = dict(model_name="swin_unetr", out_channels=6, feature_size=[48], num_heads=3,
                depth_swin_block=[2], roi_x=96, roi_y=96, roi_z=96,
                encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                decoder_norm_name="instance", infer_overlap=0.5, sw_batch_size=1)
REQUESTS = {"224^3": (224, 224, 224), "308x308x192": (308, 308, 192)}
BUILD_DIRS = ("miseg_tpu_torch/ops/kernels/_build", "miseg_tpu_torch/utils/_build")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def worker(label: str, tree: str, windows: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.inferers import window_starts
    from miseg_tpu_torch.models import model_from_config
    from miseg_tpu_torch.serve import load_bundle, save_bundle

    dev = torch.device("cuda")
    cfg = Config(**FLAGSHIP)
    torch.manual_seed(0)
    state = model_from_config(cfg, device="cpu").state_dict()
    gen = torch.Generator().manual_seed(1)
    window = torch.rand((1, *cfg.roi, 1), generator=gen)
    vols = {k: torch.rand((1, *shape, 1), generator=gen) for k, shape in REQUESTS.items()}
    out = {"label": label, "tree": tree, "card": card()}

    def request(fn, vol, mod):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(vol, torch.tensor([mod], dtype=torch.int32))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_bundle(cfg, state, Path(tmp) / "b")
        out["save_bundle_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = load_bundle(Path(tmp) / "b")
        out["load_s"] = time.perf_counter() - t0
        served(window, [0])
        torch.cuda.synchronize()
        out["load_first_window_s"] = time.perf_counter() - t0

        win = window.to(dev)
        mods = torch.tensor([0], dtype=torch.int32, device=dev)
        for _ in range(3):
            served(win, mods)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(windows):
            served(win, mods)
        end.record()
        end.synchronize()
        out["window_ms_events"] = start.elapsed_time(end) / windows
        out["window_ms_wall"] = (time.perf_counter() - t0) * 1e3 / windows

        for name, vol in vols.items():
            n = len(window_starts(vol.shape[1:-1], cfg.roi, cfg.infer_overlap)[1])
            secs = [request(served.predict, vol, mod) for mod in (0, 1)]
            out[f"predict_{name}"] = {"windows": n, "s": secs, "windows_per_s": n / secs[-1]}
        if hasattr(served, "window_fn"):
            inferer = served._inferer(served.window_fn, cfg.infer_overlap, "gaussian")
            secs = [request(inferer, vols["224^3"], mod) for mod in (0, 1)]
            out["uncaptured_224^3"] = {"s": secs, "windows_per_s": 64 / secs[-1]}
        del served

        if hasattr(sys.modules["miseg_tpu_torch.serve"], "export_bundle"):
            from miseg_tpu_torch.serve import export_bundle
            export_bundle(cfg, state, Path(tmp) / "v", volume_shapes=[REQUESTS["224^3"]])
            served = load_bundle(Path(tmp) / "v")
            secs = [request(served.predict, vols["224^3"], mod) for mod in (0, 1, 0)]
            find = getattr(served, "volume_program", None)
            prog = (find(REQUESTS["224^3"]) if find else
                    served._volume_program(REQUESTS["224^3"], 1, cfg.infer_overlap, "gaussian"))
            out["volume_graph_224^3"] = {"s": secs, "capture_s": prog.capture_s,
                                         "windows_per_s": 64 / statistics.median(secs[1:])}
            del served
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="a source tree to time, by label (repeat)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, one run each (default: each tree once)")
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/serve_ab.jsonl")
    ap.add_argument("--worker", nargs=2, metavar=("LABEL", "PATH"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(*args.worker, args.windows)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees:
        ap.error("give at least one --tree")
    order = args.order.split(",") if args.order else list(trees)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for label in order:
        root = Path(trees[label]).resolve()
        for other in trees.values():   # the libraries built so far
            for sub in BUILD_DIRS:
                src, dst = Path(other).resolve() / sub, root / sub
                if src.is_dir() and src != dst:
                    dst.mkdir(parents=True, exist_ok=True)
                    for f in src.iterdir():
                        if not (dst / f.name).exists():
                            shutil.copy2(f, dst / f.name)
        proc = subprocess.run([sys.executable, __file__, "--worker", label, str(root),
                               "--windows", str(args.windows)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
