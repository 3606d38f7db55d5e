"""Reconstruction losses for masked-image modeling (port of
``hairci/losses/recon.py``).

  - MAE: MSE on the masked patches' pixels (optionally normalised per
    patch, ``norm_pix``),
  - SimMIM: L1 on the masked patches,
  - UniGrad (SiameseIM): the standardised squared error plus the push of the
    targets' correlation, over the whole batch given.

Patches are flattened in (p, q, c) order, rows of patches in raster order,
as the JAX package flattens them. Variances are population variances.

Under data parallelism (``parallel.collectives``) UniGrad is the global
batch's, as under JAX's sharding: its means are global and the targets'
correlation is the sum of every rank's ``targetᵀ target`` over the global
row count; MAE's MSE and SimMIM's L1 are sums over every rank's masked
patches over the global mask count (``norm_pix`` stays per patch).
"""

from __future__ import annotations

from typing import Optional

import torch

from hairci_torch.parallel import collectives


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C)."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(patches: torch.Tensor, patch_size: int,
               channels: int = 3) -> torch.Tensor:
    """(B, N, patch*patch*C) -> (B, H, W, C) on a square grid."""
    B, N, _ = patches.shape
    p = patch_size
    g = int(N ** 0.5)
    x = patches.reshape(B, g, g, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * p, g * p, channels)


def _masked_mean(err: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``err`` over the masked patches of every rank: the sum
    of the errors and the mask count, each summed over the ranks, divided
    (the plain mean over every rank's rows without a mask)."""
    if mask is None:
        return collectives.global_mean(err)
    m = mask.to(err.dtype)
    tot = collectives.all_reduce_sum(torch.stack([(err * m).sum(), m.sum()]))
    return tot[0] / torch.clamp(tot[1].detach(), min=1.0)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    norm_pix: bool = False) -> torch.Tensor:
    """MSE over (masked) patches. pred/target (B, N, P); mask (B, N) with
    1 = masked (loss counted); mask=None is the plain MSE."""
    if norm_pix:
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    return _masked_mean(torch.square(pred - target).mean(-1), mask)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 over (masked) patches (SimMIM)."""
    return _masked_mean(torch.abs(pred - target).mean(-1), mask)


def _standardize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without an affine over the feature axis."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def unigrad_loss(pred: torch.Tensor, target: torch.Tensor,
                 neg_weight: float = 0.02,
                 online_ln: bool = False) -> torch.Tensor:
    """UniGrad: pred standardised when ``online_ln`` (gradient flows),
    target standardised without gradient;
    L = (E||pred - target||^2 + neg_weight E[pred C pred^T]) / dim with
    C = target^T target / B in f32 over the batch given (every rank's rows
    under data parallelism: the means and C are global)."""
    if online_ln:
        pred = _standardize(pred)
    target = _standardize(target).detach()
    pos = collectives.global_mean(torch.square(pred - target).sum(-1))
    corr = collectives.all_reduce_sum(target.float().T @ target.float()) \
        / (target.shape[0] * collectives.world())
    neg = collectives.global_mean(
        torch.einsum("bi,ij,bj->b", pred, corr.to(pred.dtype), pred))
    return (pos + neg_weight * neg) / pred.shape[-1]
