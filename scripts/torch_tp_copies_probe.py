"""Whether the ranks of a "model" line hold bitwise-equal copies of the
leaves tensor parallelism does not claim after a step on the card: four
gloo ranks sharing one card, one f32 step of C-UNETR at 64^3
(`chip_smoke.PP_UNETR_SMALL`) under PP x TP `[1, 2, 2]` with and without
FSDP on "model" and under TP `[2, 2]` ("data", "model"), and of the
flagship's model at fs 24 (`chip_smoke.MESH_SMALL`) under TP `[2, 2]`;
each once as it runs, then with `torch.backends.cudnn.deterministic` and
`torch.use_deterministic_algorithms(True, warn_only=True)`.

    python scripts/torch_tp_copies_probe.py

Prints, for each case and mode, how many replicated leaves differ
between the first two ranks of a "model" line (masters and gradients,
largest gaps), and the warnings the deterministic mode raised.  The
backward's kernels on the card need not repeat their bits, so two ranks'
copies of a gradient may differ; the gradient rule averages a "model"
line's copies (ROADMAP D11), so the masters and the reduced gradients
must agree in both modes.
"""

import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

PP_TP = cs.PP_MESH_CASES["pp x tp + fsdp [1, 2, 2]"][0]
TP_2X2 = dict(mesh_shape=[2, 2], mesh_axes=["data", "model"], tensor_parallel=True)
CASES = {"pp x tp + fsdp [1, 2, 2] unetr": (PP_TP, cs.PP_UNETR_SMALL),
         "pp x tp [1, 2, 2] unetr": ({**PP_TP, "fsdp": False}, cs.PP_UNETR_SMALL),
         "tp [2, 2] unetr": (TP_2X2, cs.PP_UNETR_SMALL),
         "tp [2, 2] swin fs 24": (TP_2X2, cs.MESH_SMALL)}
WORLD = 4


def rank_main(rank: int, rdzv: str) -> None:
    from miseg_tpu_torch.config import Config
    from miseg_tpu_torch.train.engine import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=WORLD)
    for mode in ("as it runs", "deterministic"):
        said = set()
        if mode == "deterministic":
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
        for name, (par, model) in CASES.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                trainer = Trainer(Config(**model, **par), device=dev)
                state, _ = trainer.train_step(trainer.init_state(),
                                              cs._share(cs._mesh_batch(dev, model)))
                said |= {str(w.message)[:160] for w in caught}
            mine = {n: (p.detach().cpu(), p.grad.detach().cpu())
                    for n, p in state.params.items() if n not in trainer.placements}
            line = trainer.mesh.line("model")
            every = [None] * WORLD
            dist.all_gather_object(every, mine)
            if rank == 0:
                other = every[line[1]]
                gaps = {n: (float((v - other[n][0]).abs().max()),
                            float((g - other[n][1]).abs().max()))
                        for n, (v, g) in mine.items()
                        if not (torch.equal(v, other[n][0]) and torch.equal(g, other[n][1]))}
                worst = max(gaps.values(), default=(0.0, 0.0))
                print(f"{mode}, {name}: 'model' line {line}: {len(gaps)} of {len(mine)} "
                      f"replicated leaves differ (masters by <= {worst[0]:.2e}, gradients "
                      f"<= {max(g for _, g in gaps.values()) if gaps else 0.0:.2e}); e.g. "
                      f"{sorted(gaps)[:4]}", flush=True)
            del trainer, state
        if rank == 0:
            print(f"{mode}: warnings {sorted(said)}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    from miseg_tpu_torch.ops.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "_rank", str(r), f"{tmp}/rdzv"])
                 for r in range(WORLD)]
        rcs = [p.wait(timeout=600) for p in procs]
    print(f"ranks exited {rcs} ({time.perf_counter() - t0:.1f} s with the build)")
    return max(rcs)


if __name__ == "__main__":
    if sys.argv[1:2] == ["_rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
