"""Deterministic eval preprocessing on tensors (port of the eval half of
``hairci/aug/ops.py``). Images stay uint8/float NHWC at the public boundary,
as in the JAX package."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1] (torchvision ToTensor)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """(x - mean) / std over the trailing channel axis (NHWC)."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std
