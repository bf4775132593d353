"""Activation recompute (`use_checkpoint`, the counterpart of flax's
`nn.remat` around the JAX package's swin blocks and UNETR conv blocks).

`call(module, *args, recompute=True)` runs `module(*args)` inside
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: the
block's activations are freed after the forward and recomputed in the
backward, where its kernels launch again through the same autograd
Functions.  Three things make the recompute compute what the forward did:
  * the block's parameters and buffers are captured at its entry and
    handed to the recompute (`torch.func.functional_call`): under the
    Trainer's bf16 forward, itself a `functional_call`, the module holds
    its f32 masters again by the time the backward runs;
  * dropout replays the forward's masks (`dropout.snapshot`/`replay`);
  * a batch norm's running statistics are updated on copies in the
    recompute, so a step updates them once.
The recompute runs the whole block (early stop off), so each recomputed
block launches its kernels exactly once more a step.  Without grad mode
(serving, evaluation) the block runs as it is.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils import checkpoint

from . import dropout
from .norms import RUNNING_STATS


def call(module: nn.Module, *args, recompute: bool):
    """`module(*args)`, recomputed in the backward when `recompute`."""
    if not (recompute and torch.is_grad_enabled()):
        return module(*args)
    tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    snap = dropout.snapshot()
    calls = []

    def run(*inner):
        if not calls:                      # the forward
            calls.append(1)
            return module(*inner)
        state = {n: t.clone() if n.rsplit(".", 1)[-1] in RUNNING_STATS else t
                 for n, t in tensors.items()}
        with dropout.replay(snap):
            return torch.func.functional_call(module, state, inner)

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(run, *args, use_reentrant=False,
                                     preserve_rng_state=False)
