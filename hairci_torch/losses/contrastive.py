"""The SHAM losses (port of the SHAM half of
``hairci/losses/contrastive.py``): NT-Xent, the triplet margin loss with
eps inside the absolute value (``torch.nn.TripletMarginLoss``), and the
margin-violation statistics SHAM logs and adapts k from."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from hairci_torch.eval.features import l2_normalize


def nt_xent_loss(z0: torch.Tensor, z1: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """Symmetric NT-Xent over 2B views (lightly NTXentLoss semantics)."""
    z = torch.cat([l2_normalize(z0), l2_normalize(z1)], 0)  # (2B, D)
    n = z.shape[0]
    sim = (z @ z.T) / temperature
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=z.device),
                          float("-inf"))
    pos = (torch.arange(n, device=z.device) + n // 2) % n
    return -F.log_softmax(sim, dim=1).gather(1, pos[:, None]).mean()


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0,
                        p: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """mean(max(d(a, p) - d(a, n) + margin, 0)), d the p-norm of
    ``|x - y + eps|``."""
    d_ap = torch.pow(torch.sum(torch.abs(anchor - positive + eps) ** p, -1),
                     1.0 / p)
    d_an = torch.pow(torch.sum(torch.abs(anchor - negative + eps) ** p, -1),
                     1.0 / p)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def margin_violation_stats(anchor: torch.Tensor, positive: torch.Tensor,
                           negative: torch.Tensor, margin: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(mean L2 d(a, p), mean L2 d(a, n), count of d(a,p) - d(a,n) + margin
    > 0)."""
    d_ap = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return d_ap.mean(), d_an.mean(), ((d_ap - d_an + margin) > 0).sum()
