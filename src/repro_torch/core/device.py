"""The port's device rule: an entry point runs on the CUDA card unless its
caller asks for another device, and never falls back to the CPU on its
own.  A module of its own so the executor, the kernel builders and the
runtime can all import it without an import cycle."""

from __future__ import annotations

import contextlib

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
    """Where a kernel wrapper that picks its device in Python (B1, B2, B4)
    runs for its inputs (name -> tensor): ``None`` when they all lie on the
    CPU (the wrapper takes its plain version), their CUDA device when they
    all lie there (it launches its kernel); raises for inputs on several
    devices or on any other device.  The kernels that are custom operators
    (B3, B5, B6, B7) check theirs with :func:`op_device`."""
    device = op_device(tensors, what)
    if device.type == "meta":
        raise RuntimeError(f"no {what} kernel for device {device}")
    return None if device.type == "cpu" else device


def op_device(tensors: dict, what: str) -> torch.device:
    """The one device of a custom operator's inputs (name -> tensor): the
    dispatcher then picks the operator's implementation by its type (the
    kernel on CUDA tensors, the plain version on CPU tensors, the fake one
    on fake or ``meta`` tensors).  Raises for inputs on several devices or
    on any other device type."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs span devices "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda", "meta"):
        raise RuntimeError(f"no {what} kernel for device {device}")
    return device


_card_route = [False]


@contextlib.contextmanager
def card_route():
    """While active, CPU tensors take the card's route: every kernel call
    site of the model calls its kernel's operator, B3's attention included
    (whose CPU implementation is the plain version).  A dry run traces the
    card's step so on fake CPU tensors where PyTorch is built without CUDA
    (fake CUDA tensors cannot pass its bindings' device guards there)."""
    prev = _card_route[0]
    _card_route[0] = True
    try:
        yield
    finally:
        _card_route[0] = prev


def on_card_route(device) -> bool:
    """Whether tensors on ``device`` take the card's route: CUDA tensors
    always, others inside :func:`card_route`."""
    return torch.device(device).type == "cuda" or _card_route[0]
