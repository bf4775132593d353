"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def requested_device(device: str | torch.device | None = None,
                     no_gpu: bool = False) -> str | torch.device | None:
    """The device the caller asked for: `device`, or the CPU under
    `no_gpu` (the reference's `--no_gpu`), which raises beside a device
    that is not the CPU.  None leaves the choice to `resolve_device`."""
    if not no_gpu:
        return device
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError(f"no_gpu asks for the CPU, but the device asked for is {device}")
    return "cpu"


def resolve_device(device: str | torch.device | None = None, *,
                   no_gpu: bool = False) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another or sets `no_gpu`.  Raises when a CUDA device is wanted
    and none exists — the port never moves to the CPU behind the caller's
    back."""
    device = requested_device(device, no_gpu)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
