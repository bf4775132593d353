"""ADN: optional Activation / Dropout / Norm in a configurable order
(counterpart of `miseg_tpu/nn/adn.py`).

The parts are named as flax names them: `A` (a `PReLU` holds the slope
`A.slope`), `D` (the port's seeded `Dropout`) and `N` (a `Norm`, given
the modalities).  With the default `NDA`, an instance norm runs K1 + K2
without a fused activation and the activation runs after it on its own,
as in the JAX package.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from .dropout import Dropout
from .factories import get_act
from .norms import make_norm


class ADN(nn.Module):
    def __init__(self, channels: int, ordering: str = "NDA",
                 act: str | tuple[str, dict[str, Any]] | None = "relu",
                 norm: tuple[str, dict[str, Any]] | str | None = None,
                 dropout: float | None = None, *, device=None, dtype=None):
        super().__init__()
        self.ordering = ordering.upper()
        bad = set(self.ordering) - set("ADN")
        if bad:
            raise ValueError(f"ordering must only contain A, D, N; got {sorted(bad)}")
        self.steps = [item for item in self.ordering
                      if (item == "A" and act is not None) or (item == "D" and dropout)
                      or (item == "N" and norm is not None)]
        if "A" in self.steps:
            self.A = get_act(act, device=device, dtype=dtype)
        if "D" in self.steps:
            self.D = Dropout(float(dropout))
        if "N" in self.steps:
            self.N = make_norm(norm, channels, device=device, dtype=dtype)

    def forward(self, x, modalities=None):
        for item in self.steps:
            x = self.N(x, modalities) if item == "N" else getattr(self, item)(x)
        return x
