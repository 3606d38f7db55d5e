"""Contrastive losses (port of ``hairci/losses/contrastive.py``): NT-Xent
(SimCLR and SHAM), the supervised contrastive loss (SupCon), the triplet
margin loss with eps inside the absolute value
(``torch.nn.TripletMarginLoss``), and the margin-violation statistics SHAM
logs and adapts k from; and the reference's losses no recipe calls: NT-Xent
with one anchor and two positives, the cosine-distance margin losses (one-
and two-sided) and the MSE of normalised embeddings.

Under data parallelism (``parallel.collectives``) NT-Xent, the triplet loss,
the margin statistics and SupCon are the global batch's, as under JAX's
sharding: NT-Xent gathers both views from every rank, so its negatives
span the global 2B views; SupCon gathers the views and the labels, so its
positives and negatives span them too; the triplet loss and the
statistics are means (the violations a sum) over the global batch."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hairci_torch.eval.features import l2_normalize
from hairci_torch.parallel import collectives


def nt_xent_loss(z0: torch.Tensor, z1: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """Symmetric NT-Xent over 2B views (lightly NTXentLoss semantics); the
    views of every rank under data parallelism."""
    # both views of every rank, (W * 2, b, D) in rank order; without a
    # process group the same steps (and no collective), so that autograd
    # sums the gradients in the same order with a one-rank group
    zz = collectives.all_gather(torch.stack([z0, z1]))
    zz = zz.reshape(-1, 2, *z0.shape)
    z0, z1 = (zz[:, 0].reshape(-1, z0.shape[1]),
              zz[:, 1].reshape(-1, z1.shape[1]))
    z = torch.cat([l2_normalize(z0), l2_normalize(z1)], 0)  # (2B, D)
    n = z.shape[0]
    sim = (z @ z.T) / temperature
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=z.device),
                          float("-inf"))
    pos = (torch.arange(n, device=z.device) + n // 2) % n
    return -F.log_softmax(sim, dim=1).gather(1, pos[:, None]).mean()


def nt_xent_1anchor_2positive(anchor: torch.Tensor, pos1: torch.Tensor,
                              pos2: torch.Tensor,
                              temperature: float = 0.5) -> torch.Tensor:
    """One anchor, two positives (``losses.py:585-613``): each anchor row
    against the 3B bank [anchors, pos1, pos2] less itself; the loss is the
    mean of its two positives' log-probabilities, negated."""
    a, p1, p2 = l2_normalize(anchor), l2_normalize(pos1), l2_normalize(pos2)
    B = a.shape[0]
    sim = (a @ torch.cat([a, p1, p2], 0).T) / temperature
    own = torch.arange(B, device=a.device)
    sim = sim.masked_fill(F.one_hot(own, 3 * B).bool(), float("-inf"))
    logprob = F.log_softmax(sim, dim=1)
    return -((logprob[own, own + B] + logprob[own, own + 2 * B]) / 2.0).mean()


def supcon_loss(features: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                temperature: float = 0.07, base_temperature: float = 0.07,
                contrast_mode: str = "all") -> torch.Tensor:
    """Supervised contrastive loss (Khosla et al.) on (B, n_views, D)
    L2-normalised features. ``labels`` (B,) marks the positives; ``None``
    keeps only the other views of the same sample (the SimCLR case).

    Under data parallelism ``features`` and ``labels`` are this rank's rows
    of the global batch: both are gathered from every rank, this rank's
    anchors are contrasted with all the global batch's views (their
    positives from the global labels, the self-mask at each anchor's global
    row), and the loss is the mean over every rank's anchors."""
    b, V, _ = features.shape
    # without a process group the same steps (and no collective), so that
    # autograd sums the gradients in the same order with a one-rank group
    every = collectives.all_gather(features)               # (B, V, D)
    B = every.shape[0]
    # view-major rows: [view 0 of every sample, view 1 of every sample, ...]
    feats = torch.cat(torch.unbind(every, dim=1), dim=0)
    if labels is None:
        labels = torch.arange(B, device=features.device)
    else:
        labels = collectives.all_gather(labels.reshape(b))
    if contrast_mode not in ("one", "all"):
        raise ValueError(contrast_mode)
    own = collectives.rank() * b + torch.arange(b, device=features.device)
    # this rank's anchors: view 0 of its samples ("one"), or every view
    rows = torch.cat([own + v * B for v in range(
        1 if contrast_mode == "one" else V)])
    anchor = feats[rows]
    logits = (anchor.float() @ feats.float().T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    sample = labels.repeat(V)                       # each row's sample label
    mask = (sample[rows][:, None] == sample[None, :]).float()
    logits_mask = 1.0 - F.one_hot(rows, B * V).float()
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True) + 1e-12)
    mask_sum = torch.clamp(mask.sum(1), min=1e-12)
    mean_log_prob_pos = (mask * log_prob).sum(1) / mask_sum
    return collectives.global_mean(
        -(temperature / base_temperature) * mean_log_prob_pos)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0,
                        p: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """mean(max(d(a, p) - d(a, n) + margin, 0)), d the p-norm of
    ``|x - y + eps|``; the mean over every rank's rows."""
    d_ap = torch.pow(torch.sum(torch.abs(anchor - positive + eps) ** p, -1),
                     1.0 / p)
    d_an = torch.pow(torch.sum(torch.abs(anchor - negative + eps) ** p, -1),
                     1.0 / p)
    return collectives.global_mean(torch.clamp(d_ap - d_an + margin,
                                               min=0.0))


def margin_violation_stats(anchor: torch.Tensor, positive: torch.Tensor,
                           negative: torch.Tensor, margin: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(mean L2 d(a, p), mean L2 d(a, n), count of d(a,p) - d(a,n) + margin
    > 0), over every rank's rows."""
    d_ap = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return (collectives.global_mean(d_ap), collectives.global_mean(d_an),
            collectives.all_reduce_sum(((d_ap - d_an + margin) > 0).sum()))


def positive_consistency_loss_margin(anchor: torch.Tensor,
                                     positive: torch.Tensor,
                                     margin: float = 0.3) -> torch.Tensor:
    """mean(max(1 - cos(a, p) - margin, 0)) (``losses.py:544-558``)."""
    d = 1.0 - torch.sum(l2_normalize(anchor) * l2_normalize(positive), -1)
    return torch.clamp(d - margin, min=0.0).mean()


def bidirectional_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                              negative: torch.Tensor, margin_pos: float = 0.3,
                              margin_neg: float = 0.7) -> torch.Tensor:
    """Positives pulled within ``margin_pos``, negatives pushed beyond
    ``margin_neg`` in cosine distance: the JAX package's explicit form of
    the reference's broken ``losses.py:561-580``."""
    a = l2_normalize(anchor)
    d_pos = 1.0 - torch.sum(a * l2_normalize(positive), -1)
    d_neg = 1.0 - torch.sum(a * l2_normalize(negative), -1)
    return (torch.clamp(d_pos - margin_pos, min=0.0)
            + torch.clamp(margin_neg - d_neg, min=0.0)).mean()


def mse_alignment_loss(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """MSE between L2-normalised embeddings (``utils/utils.py:36-44``)."""
    return torch.mean(torch.square(l2_normalize(pred) - l2_normalize(target)))
