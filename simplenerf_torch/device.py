"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA device; a CUDA request without a card raises.

    Entry points never fall back to the CPU on their own: a caller that
    wants the host passes `device="cpu"`.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev
