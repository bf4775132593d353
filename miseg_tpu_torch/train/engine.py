"""One training step (counterpart of `miseg_tpu/train/engine.py`: `TrainState`
:53, `apply_fn` :106, `init_state` :171 without its tensor-parallel, FSDP
and pretrained branches, `_build_train_step` :239, `train_step` :271 and
`make_inferer` :328).

The parameters are f32 masters.  The forward casts every floating
parameter to the compute dtype (bf16 when `cfg.amp`) through a
differentiable cast and runs the model on those copies
(`torch.func.functional_call`), so the backward lands in the f32 masters;
the image is cast to the compute dtype and the logits to f32 before the
loss.  On the card every kernel of the forward (K1 and its fold, K2, K3,
K4, K5) runs inside its autograd Function.  The model runs in `train()`
mode; the port has no dropout yet (the JAX rates default to 0).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn

from ..config import Config
from ..inferers import SlidingWindowInferer
from ..losses import loss_from_config
from ..models import model_from_config
from ..utils.platform import resolve_device
from .optim import optimizer_from_config


@dataclasses.dataclass
class TrainState:
    """The f32 master parameters by name (the model's own tensors, updated
    in place), their optimizer and the count of steps taken."""
    params: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0


class Trainer:
    def __init__(self, cfg: Config, model: nn.Module | None = None, *, device=None,
                 fused_conv: bool = True):
        """`cfg`'s model on `device` (the CUDA card unless given), or
        `model` as it is; `fused_conv` selects the conv blocks' path of a
        model built here."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else model_from_config(
            cfg, device=self.device, fused_conv=fused_conv)
        self.model.train()
        self.loss_fn = loss_from_config(cfg)
        self.compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
        self._inferers: dict[str, SlidingWindowInferer] = {}

    def init_state(self, params: Mapping[str, torch.Tensor] | None = None) -> TrainState:
        """The initial state: the model's parameters (replaced by the state
        dict `params` when given, e.g. one bridged from JAX) as f32
        masters, and `cfg`'s optimizer over them."""
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        masters = dict(self.model.named_parameters())
        wrong = [n for n, p in masters.items() if p.dtype != torch.float32]
        if wrong:
            raise ValueError(f"master parameters must be float32: {wrong[:3]}")
        return TrainState(masters, optimizer_from_config(self.cfg, masters.values()))

    def apply_fn(self, params: Mapping[str, torch.Tensor], image, modalities):
        """Forward under the compute policy: f32 logits of `image` from the
        parameters cast to the compute dtype."""
        cast = {n: p.to(self.compute_dtype) if p.is_floating_point() else p
                for n, p in params.items()}
        logits = torch.func.functional_call(
            self.model, cast, (image.to(self.compute_dtype), modalities))
        return logits.float()

    def make_inferer(self, mode: str = "constant") -> SlidingWindowInferer:
        """A sliding-window inferer (one per blend `mode`, cached) over the
        model's current parameters: each window group runs `apply_fn`, so
        in the compute dtype with f32 logits, and the inferer runs under
        `inference_mode`."""
        if mode not in self._inferers:
            cfg = self.cfg
            self._inferers[mode] = SlidingWindowInferer(
                lambda w, m: self.apply_fn(dict(self.model.named_parameters()), w, m),
                roi_size=cfg.roi, sw_batch_size=cfg.sw_batch_size,
                overlap=cfg.infer_overlap, mode=mode,
                out_channels=cfg.out_channels, device=self.device)
        return self._inferers[mode]

    def _batch(self, batch: Mapping):
        image = torch.as_tensor(batch["image"], device=self.device)
        label = torch.as_tensor(batch["label"], device=self.device)
        if label.ndim == 5 and label.shape[-1] == 1:
            label = label[..., 0]
        mods = batch.get("modality")
        if mods is not None:
            mods = torch.as_tensor(mods, dtype=torch.int32, device=self.device)
        return image, label, mods

    def value_and_grad(self, state: TrainState, batch: Mapping):
        """The loss of `batch` (image `[B, *S, Cin]`, integer label
        `[B, *S]` or `[B, *S, 1]`, modality `int[B]`) and the gradients of
        the masters by name, left in their `.grad`; nothing is updated."""
        image, label, mods = self._batch(batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.apply_fn(state.params, image, mods), label)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in state.params.items()}

    def train_step(self, state: TrainState, batch: Mapping):
        """One step: loss, backward into the f32 masters, one optimizer
        update.  Returns (the same state, advanced, and the loss as a
        0-d tensor on the device)."""
        loss, _ = self.value_and_grad(state, batch)
        state.optimizer.step()
        state.step += 1
        return state, loss
