"""Explicit device selection: ``cuda`` or ``cpu``, never a silent fallback
from one to the other."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; raises DeviceUnavailable for
    ``cuda`` without a CUDA device.  Also pins full-float32 matmuls and
    convolutions (no TF32), the reference's Precision.HIGHEST."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r} (expected cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "--device cuda: no CUDA device is available "
            "(torch.cuda.is_available() is false)")
    return torch.device("cuda", torch.cuda.current_device())
