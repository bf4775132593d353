"""Optimizer factory: Adam, AdamW and SGD with Nesterov momentum, weight
decay `reg_weight`, the encoder freeze, gradient accumulation and the
learning rate set from the host (counterpart of
`miseg_tpu/train/optim.py`).

Each optimizer matches the optax transform the JAX package builds:
  * `adamw`: `optax.adamw(lr, weight_decay=reg_weight)`, decoupled decay
    over every parameter (optax masks nothing, so norm scales and biases
    decay too), betas (0.9, 0.999), eps 1e-8;
  * `adam`: the L2 term added to the gradient before Adam
    (`add_decayed_weights` then `scale_by_adam`), which is what
    `torch.optim.Adam`'s `weight_decay` does;
  * `sgd`: the decay added to the gradient, then momentum `cfg.momentum`
    with Nesterov's update (`optax.sgd(..., nesterov=True)`).
With `freeze_encoder`, the parameters under the model's
`ENCODER_PREFIXES` are left out of the optimizer: no update, no decay and
no state, as `optax.set_to_zero` gives them.  The learning rate lives in
the param groups (`set_learning_rate`), the counterpart of
`optax.inject_hyperparams`.  `Accumulation` is `optax.MultiSteps`.
"""

from __future__ import annotations

import fnmatch
from collections.abc import Iterable, Mapping, Sequence

import torch


def freeze_mask(names: Iterable[str], prefixes: Sequence[str]) -> set[str]:
    """The parameter names (dotted, as in a state dict) to freeze: a prefix
    holding '/' or '*' is an fnmatch pattern over the '/'-joined path,
    any other matches the top-level module by prefix (JAX's rule, so
    'encoder1' also matches 'encoder10')."""
    frozen = set()
    for name in names:
        keys = name.split(".")
        full = "/".join(keys)
        for pat in prefixes:
            if ("/" in pat or "*" in pat) and fnmatch.fnmatch(full, pat):
                frozen.add(name)
            elif keys[0].startswith(pat):
                frozen.add(name)
    return frozen


def optimizer_from_config(cfg, params: Mapping[str, torch.Tensor] | Iterable[torch.Tensor],
                          encoder_prefixes: Sequence[str] = ()) -> torch.optim.Optimizer:
    """`cfg`'s optimizer over `params` (tensors, or tensors by name; with
    `cfg.freeze_encoder` the names under `encoder_prefixes` are left out)."""
    if isinstance(params, Mapping):
        frozen = (freeze_mask(params, encoder_prefixes)
                  if getattr(cfg, "freeze_encoder", False) else set())
        params = [p for n, p in params.items() if n not in frozen]
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


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class Accumulation:
    """`optax.MultiSteps(every_k_schedule=k)`: each micro-batch's gradient
    folds into a running mean (`acc + (g - acc) / (m + 1)`), and the k-th
    hands the mean to the optimizer.  `flush` applies a part-filled window
    of m < k micro-batches as mean_m(grad) * m / k
    (`make_accumulation_flush`, miseg_tpu/train/optim.py:84-120): the
    reference loop's step at the last batch of an epoch with every
    micro-loss scaled by 1/k.  Under data parallelism the window's mean is
    averaged over the ranks before it is applied (once a window, not once
    a micro-batch), by `reduce(window means, params)` (the Trainer's, which
    leaves out what FSDP's reduce-scatter averaged)."""

    def __init__(self, k: int, reduce):
        self.k = int(k)
        self.reduce = reduce
        self.mini_step = 0
        self.gradient_step = 0
        self._acc: list[torch.Tensor] | None = None

    def _params(self, optimizer):
        return [p for g in optimizer.param_groups for p in g["params"]]

    def step(self, optimizer: torch.optim.Optimizer) -> None:
        """Fold the parameters' `.grad` into the window; step the optimizer
        on the window's mean when it fills."""
        params = self._params(optimizer)
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in params]
        m = self.mini_step
        for acc, p in zip(self._acc, params):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (m + 1))
        self.mini_step += 1
        if self.mini_step == self.k:
            self._apply(optimizer, params, 1.0)

    def flush(self, optimizer: torch.optim.Optimizer) -> bool:
        """Apply a part-filled window; False (and nothing done) when the
        window is empty."""
        if self.mini_step == 0:
            return False
        self._apply(optimizer, self._params(optimizer), self.mini_step / self.k)
        return True

    @torch.no_grad()
    def _apply(self, optimizer, params, scale: float) -> None:
        self.reduce(self._acc, params)
        for acc, p in zip(self._acc, params):
            p.grad = acc * scale
        optimizer.step()
        for acc in self._acc:
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict(self) -> dict:
        """The counters.  The window's sums are not kept: `Trainer.fit`
        flushes it at every epoch's end, before it saves a checkpoint."""
        return {"mini_step": self.mini_step, "gradient_step": self.gradient_step}

    def load_state_dict(self, d: Mapping) -> None:
        if int(d.get("mini_step", 0)):
            raise ValueError("cannot resume inside an accumulation window")
        self.gradient_step = int(d.get("gradient_step", 0))


def optimizer_step_count(opt_state: Mapping, iters_to_accumulate: int = 1) -> int:
    """Micro-steps taken, recovered from a checkpoint's `opt_state`
    (`{"optimizer": ..., "gradient_step", "mini_step"}`): resumes the step
    counter, and with it the dropout stream."""
    if not opt_state:
        return 0
    return (int(opt_state.get("gradient_step", 0)) * max(1, iters_to_accumulate)
            + int(opt_state.get("mini_step", 0)))
