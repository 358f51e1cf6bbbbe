"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None``
means ``cuda``.  Asking for ``cuda`` on a machine without a usable card is
an error, never a silent fall-back to the CPU — the CPU path exists for the
tests and for callers that pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
