"""Explicit device resolution.

The port never picks a device on its own: callers name one and pass the
resulting ``torch.device`` down. Asking for CUDA where there is none is an
error, not a quiet move to the CPU — the CPU serves only callers that ask
for it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """-> ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False (no CUDA build of torch, or no visible card)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def pin_f32_matmul(device: torch.device) -> None:
    """On CUDA, f32 matmuls in full precision (``allow_tf32`` off): the
    training losses' ``za @ zp.T``, the plain paths and the exact scans are
    f32 products, and a process that had asked for TF32 would round their
    operands to 10 mantissa bits. The entry points that compute them call
    this (``serve.api.startup`` pins the same flag)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


# -- the device of the in-process models ---------------------------------------
# The models (models/*) serve inside a process whose entry point named a
# device: the server's ``startup(device)``, the embed service's
# ``--device``, a script's or a gate's ``device``. That entry point sets it
# here and the providers build their weights on it; a provider never picks
# one itself.
_models_device: Optional[torch.device] = None


def set_models_device(device: DeviceLike) -> torch.device:
    global _models_device
    _models_device = resolve_device(device)
    return _models_device


def models_device() -> torch.device:
    """The device set by ``set_models_device``; raises when none was."""
    if _models_device is None:
        raise RuntimeError(
            "no device named for the in-process models: the entry point "
            "(serve.api.startup, serve.embed_service, a gate or a script's "
            "--device) sets it with device.set_models_device")
    return _models_device
