"""Feature helpers (port of ``hairci/eval/features.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize parity over the last axis:
    x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)
