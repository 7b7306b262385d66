"""Explicit device resolution.

The port never picks a device on its own: callers name one and pass the
resulting ``torch.device`` down. Asking for CUDA where there is none is an
error, not a quiet move to the CPU — the CPU serves only callers that ask
for it (the tests do).
"""

from __future__ import annotations

from typing import Union

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
