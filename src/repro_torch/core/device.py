"""The port's device rule: an entry point runs on the CUDA card unless its
caller asks for another device, and never falls back to the CPU on its
own.  A module of its own so the executor, the kernel builders and the
runtime can all import it without an import cycle."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device asked for, else the CUDA card; raises when neither is
    given nor available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def kernel_device(tensors: dict, what: str):
    """Where a kernel wrapper runs for its inputs (name -> tensor): ``None``
    when they all lie on the CPU (the wrapper takes its plain version),
    their CUDA device when they all lie there (it launches its kernel);
    raises for inputs on several devices or on any other device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs span devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise RuntimeError(f"no {what} kernel for device {device}")
    return device
