"""Optimizer factory: Adam, AdamW and SGD with Nesterov momentum, weight
decay `reg_weight` (counterpart of `miseg_tpu/train/optim.py:26`
`_base_optimizer` and `:66` `optimizer_from_config`, without the freeze
mask and without gradient accumulation).

Each matches the optax transform the JAX package builds:
  * `adamw`: `optax.adamw(lr, weight_decay=reg_weight)`, decoupled decay
    over every parameter (optax masks nothing, so norm scales and biases
    decay too), betas (0.9, 0.999), eps 1e-8;
  * `adam`: the L2 term added to the gradient before Adam
    (`add_decayed_weights` then `scale_by_adam`), which is what
    `torch.optim.Adam`'s `weight_decay` does;
  * `sgd`: the decay added to the gradient, then momentum `cfg.momentum`
    with Nesterov's update (`optax.sgd(..., nesterov=True)`).
"""

from __future__ import annotations

from collections.abc import Iterable

import torch


def optimizer_from_config(cfg, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    name = cfg.optim_name
    if name == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.reg_weight)
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.reg_weight)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, nesterov=True,
                               weight_decay=cfg.reg_weight)
    raise ValueError(f"optimizer {name!r} is not implemented")
