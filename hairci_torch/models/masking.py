"""Token masks for masked-image SSL (port of ``hairci/models/masking.py``).

Each mask is split as the port's augmentations are: a draw half that takes
uniform noise from an explicit CPU ``torch.Generator``, and a pure function
of that noise on any device, so a test can hand JAX's
``jax.random.uniform`` noise to the pure half and compare bitwise.

Sorting is stable everywhere (``torch.argsort(..., stable=True)``), as
``jnp.argsort`` is: JAX's uniform f32 has 23 random bits, so a row of 196
tokens holds a tie about once in 430 rows, and ``mask_to_ids_keep`` sorts a
0/1 mask, which is all ties. Keep counts are Python ints, with the JAX
package's expressions.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draw_token_noise(gen: torch.Generator, batch: int,
                     num_tokens: int) -> torch.Tensor:
    """(B, N) uniform noise that orders the tokens of each row."""
    return torch.rand((batch, num_tokens), generator=gen)


def random_token_mask_from_noise(noise: torch.Tensor, mask_ratio: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """MAE-style shuffle masking from (B, N) noise: the tokens of lowest
    noise are kept. Returns (ids_keep (B, K), ids_restore (B, N), mask
    (B, N) f32, 1 = masked)."""
    batch, num_tokens = noise.shape
    num_keep = int(num_tokens * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :num_keep]
    mask = torch.ones((batch, num_tokens), dtype=torch.float32,
                      device=noise.device)
    mask[:, :num_keep] = 0.0
    return ids_keep, ids_restore, torch.gather(mask, 1, ids_restore)


def random_token_mask(gen: torch.Generator, batch: int, num_tokens: int,
                      mask_ratio: float):
    """Draw the noise and mask (``random_token_mask_from_noise``)."""
    return random_token_mask_from_noise(
        draw_token_noise(gen, batch, num_tokens), mask_ratio)


def block_grid(grid: int, block: int) -> Tuple[int, int]:
    """(block, coarse): blocks shrink so the coarse grid keeps >= 2 cells a
    side; the coarse grid is the ceiling, so grids the block does not
    divide are covered and cropped."""
    block = max(min(block, grid // 2), 1)
    return block, max(-(-grid // block), 1)


def draw_block_scores(gen: torch.Generator, batch: int, grid: int,
                      block: int = 4) -> torch.Tensor:
    """(B, coarse, coarse) uniform scores of the coarse blocks."""
    _, coarse = block_grid(grid, block)
    return torch.rand((batch, coarse, coarse), generator=gen)


def random_block_mask_from_scores(scores: torch.Tensor, grid: int,
                                  mask_ratio: float,
                                  block: int = 4) -> torch.Tensor:
    """Blockwise boolean mask (B, grid*grid), True = masked: the k coarse
    cells of lowest score (every cell tied with the k-th too), each
    upsampled to ``block`` x ``block`` patches and cropped to the grid."""
    block, coarse = block_grid(grid, block)
    batch = scores.shape[0]
    k = max(int(round(mask_ratio * coarse * coarse)), 1)
    thresh = torch.sort(scores.reshape(batch, -1), dim=1).values[:, k - 1]
    cmask = scores <= thresh[:, None, None]
    mask = cmask.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return mask[:, :grid, :grid].reshape(batch, grid * grid)


def random_block_mask(gen: torch.Generator, batch: int, grid: int,
                      mask_ratio: float, block: int = 4):
    """Draw the scores and mask (``random_block_mask_from_scores``)."""
    return random_block_mask_from_scores(
        draw_block_scores(gen, batch, grid, block), grid, mask_ratio, block)


def mask_to_ids_keep(mask: torch.Tensor, num_keep: int) -> torch.Tensor:
    """(B, N) mask (1 = masked) -> (B, num_keep) kept indices, in their
    original order (a stable sort of the 0/1 mask)."""
    return torch.argsort(mask.to(torch.int32), dim=1, stable=True)[:, :num_keep]

