"""`test` — evaluate a checkpoint on the test split (counterpart of
`miseg_tpu/cli/test.py`; a model evaluation, not a unit test).

    python -m miseg_tpu_torch.cli.test --ckpt_path experiments/experiment/best.ckpt \
        --model_name swin_unetr ... --data_dirs dataset/MM-WHS --json_lists CT_test.json

Load the checkpoint (`--ckpt_path`, or `--pretrained`: the port's, the
JAX package's msgpack or the reference's `.pt`/`.ckpt`) into `cfg`'s
model, run constant-blend sliding-window inference over every test
volume, and report Dice and symmetric surface distance by class and by
modality (logged to `<default_root_dir>/metrics.jsonl`).
"""

from __future__ import annotations

from ..config import Config
from ..data.multi_modal import get_loaders
from ..train.checkpoint import load_any_checkpoint_params
from ..train.engine import Trainer
from . import parse_args


def main(cfg: Config | None = None, *, device=None) -> dict:
    """The test metrics of `cfg.ckpt_path` (or `cfg.pretrained`) on
    `device` (the CUDA card unless given)."""
    if cfg is None:
        cfg, device = parse_args()
    if not cfg.ckpt_path and not cfg.pretrained:
        raise ValueError("provide --ckpt_path (or --pretrained) to evaluate")
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(load_any_checkpoint_params(
        cfg.ckpt_path or cfg.pretrained, trainer.model.state_dict(),
        model_name=cfg.model_name))
    metrics = trainer.evaluate(get_loaders(cfg, test_mode=True), state, prefix="test",
                               compute_surface=True)
    for k in sorted(metrics):
        print(f"{k}: {metrics[k]:.4f}")
    return metrics


if __name__ == "__main__":
    main()
