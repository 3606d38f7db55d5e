"""Hair-region patch masking (port of ``hairci/aug/hair_masking.py``).

Hair patches are those whose mean exceeds ``threshold``; per image a ratio
``r ~ U(lo, hi)`` masks ``floor(r * n_hair)`` of them: the ones with the
smallest random scores among the hair patches. The draw half gives
(ratio (B,), scores (B, P)); the apply half is pure selection logic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hairci_torch.aug.ops import to_device, uniform


def patch_means(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, P) mean over each patch and its channels."""
    B, H, W, C = x.shape
    ph, pw = H // patch_size, W // patch_size
    x = x[:, :ph * patch_size, :pw * patch_size, :]
    x = x.reshape(B, ph, patch_size, pw, patch_size, C)
    return x.mean(dim=(2, 4, 5)).reshape(B, ph * pw)


def draw_mask(gen: torch.Generator, B: int, H: int, W: int,
              patch_size: int = 32, mask_ratio_range=(0.1, 0.2)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ratio (B,), scores (B, P))."""
    P = (H // patch_size) * (W // patch_size)
    return (uniform(gen, (B,), mask_ratio_range[0], mask_ratio_range[1]),
            uniform(gen, (B, P)))


def mask_hair_patches(x: torch.Tensor, ratio: torch.Tensor,
                      scores: torch.Tensor, patch_size: int = 32,
                      threshold: float = 0.01) -> torch.Tensor:
    """Zero the drawn subset of each image's hair patches."""
    B, H, W, C = x.shape
    ph, pw = H // patch_size, W // patch_size
    P = ph * pw
    ratio, scores = to_device(ratio, x.device), to_device(scores, x.device)
    hair = patch_means(x, patch_size) > threshold               # (B, P)
    num_mask = torch.floor(ratio * hair.sum(1)).long()           # (B,)
    scores = torch.where(hair, scores, torch.full_like(scores, 2.0))
    kth = torch.sort(scores, dim=1).values.gather(
        1, torch.clamp(num_mask - 1, 0, P - 1)[:, None])
    masked = hair & (scores <= kth) & (num_mask[:, None] > 0)
    keep = (1.0 - masked.to(x.dtype)).reshape(B, ph, pw)
    keep = keep.repeat_interleave(patch_size, 1).repeat_interleave(
        patch_size, 2)
    keep = torch.nn.functional.pad(
        keep, (0, W - keep.shape[2], 0, H - keep.shape[1]), value=1.0)
    return x * keep[..., None]
