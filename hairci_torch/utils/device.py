"""Device resolution. There is no silent CPU path: the default device is
CUDA, and asking for it without a card raises."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when CUDA
    is asked for and absent -- pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev

