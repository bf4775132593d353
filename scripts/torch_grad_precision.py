"""How far a C-UNet's gradients in the PyTorch port are from exact, on the
card and on the CPU.

One forward and backward of `chip_smoke.CUNET` at 64^3, batch 2 (the
inputs of `chip_smoke.unet_card_vs_cpu`), in train mode, from one set of
seeded weights: with batch norms in f32 and f64 on the CPU and on the card,
and with the default instance norms in f32.  For each pair it prints the
summed and largest gradient gap and the leaves whose gap is the largest
share of the leaf's size (its largest element in the reference), and a
line a depth with the worst such share of each pair.  `--num_layers`
takes C-UNet's depths to run (levels of 2 * feature_size * 2^i channels,
strides 2 between them; default 4, the JAX package's).

The f64 runs keep batch norm's statistics in f32 (`ops.norms.batch_stats`,
as the JAX package does), so they are not exact evaluations; the deep
leaves' 1-2% is PReLU's gate at 0 (ROADMAP W11), which
`tests/test_torch_grad_precision.py` holds against JAX's f32 on the CPU.

Run from the repo root on a machine with a CUDA card:

    python scripts/torch_grad_precision.py [--num_layers 3 4 5]
"""

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from miseg_tpu_torch.config import Config  # noqa: E402
from miseg_tpu_torch.losses import loss_from_config  # noqa: E402
from miseg_tpu_torch.models import model_from_config  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
size = 64
gen = torch.Generator().manual_seed(17)
x = torch.randn((2, size, size, size, 1), generator=gen)
mods = torch.tensor([0, 1], dtype=torch.int32)
roi = {"roi_x": size, "roi_y": size, "roi_z": size}
label = torch.randint(0, 6, (2, size, size, size), generator=gen)


def grads(cfg, device, dtype, sd):
    m = model_from_config(cfg, device=device, dtype=dtype)
    m.load_state_dict(sd)
    m.train()
    loss = loss_from_config(cfg)(m(x.to(device, dtype), mods.to(device)), label.to(device))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu().double()
                                  for n, p in m.named_parameters()}


parser = argparse.ArgumentParser()
parser.add_argument("--num_layers", type=int, nargs="+", default=[4])
args = parser.parse_args()
print(torch.cuda.get_device_name(0))
summary = []
for depth, norms in [(d, n) for d in args.num_layers for n in ("batch", "instance")]:
    kw = ({"encoder_norm_name": "batch", "decoder_norm_name": "batch"} if norms == "batch" else {})
    cfg = Config(**{**cs.CUNET, **roi, **kw, "no_amp": True, "num_layers": depth,
                    "strides": [2] * (depth - 1)})
    tag = f"{norms} depth {depth}"
    sd = model_from_config(cfg, device="cpu").state_dict()
    runs = {}
    for name, device, dtype in (("cpu32", "cpu", torch.float32), ("card32", dev, torch.float32),
                                ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        if norms == "instance" and dtype == torch.float64:
            continue   # K1 and K2 take f32, bf16 and f16 only
        t0 = time.perf_counter()
        runs[name] = grads(cfg, device, dtype, sd)
        print(f"{tag} {name}: loss {runs[name][0]:.10f} ({time.perf_counter() - t0:.1f} s)")
    ref = runs.get("cpu64", runs["cpu32"])[1]
    pairs = [("card32", "cpu32")] + ([("cpu32", "cpu64"), ("card32", "cpu64"), ("card64", "cpu64")]
                                    if "cpu64" in runs else [])
    for a, b in pairs:
        ga, gb = runs[a][1], runs[b][1]
        rows = []
        for n in ga:
            s = float(ref[n].abs().max())
            gap = float((ga[n] - gb[n]).abs().max())
            rows.append((gap / s if s > 1e-6 else 0.0, gap, s, n))
        rows.sort(reverse=True)
        print(f"  {tag} {a} vs {b}: summed gap {sum(r[1] for r in rows):.3e}, worst abs "
              f"{max(r[1] for r in rows):.3e}; worst relative:")
        for r in rows[:6]:
            print(f"    {r[0]:.3e} (gap {r[1]:.3e}, size {r[2]:.3e}) {r[3]}")
        summary.append(f"{tag}: {a} vs {b} worst relative {rows[0][0]:.3e} ({rows[0][3]})")
print("summary (worst gap as a share of its leaf's largest element):")
print("\n".join(summary))
