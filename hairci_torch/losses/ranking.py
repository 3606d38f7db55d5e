"""Ranking losses (port of ``hairci/losses/ranking.py``).

``s2r2_loss``: differentiable Smooth-AP, a sigmoid-relaxed rank matrix over
all pairs of every query, O(N^3) work. The reference materialises the whole
(N, N, N) difference tensor; here it is taken over chunks of ``CHUNK``
queries, each under ``torch.utils.checkpoint``, so the backward recomputes a
chunk instead of keeping it and live memory stays O(CHUNK * N^2). At SHAM's
B=256 (N = 768) the whole tensor would be 1.8 GB in f32, plus what autograd
keeps of it.

Under data parallelism (``parallel.collectives``) the loss is the global
batch's, as under JAX's sharding: each rank ranks its own queries against
every rank's keys, and the loss is the global mean of their APs. The keys
are gathered as a stack of the views, so that they stand in the global
order [v1 of all B; v2 of all B; ...] with the global targets and
self-mask, whatever the number of ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from hairci_torch.parallel import collectives

CHUNK = 64   # queries a chunk: 151 MB of f32 differences at N = 768


def _ap_of_queries(sim_q: torch.Tensor, pos_q: torch.Tensor,
                   all_q: torch.Tensor, tau: float) -> torch.Tensor:
    """AP of a chunk of queries from their rows of ``sim`` and the masks,
    in the JAX package's order of operations."""
    diff = sim_q[:, None, :] - sim_q[:, :, None]
    sig = torch.sigmoid(diff / tau)
    rank_pos = 1.0 + torch.sum(sig * pos_q[:, None, :], dim=2)
    rank_all = 1.0 + torch.sum(sig * all_q[:, None, :], dim=2)
    ap_ratio = rank_pos / (rank_all + 1e-8)
    ap_sum = torch.sum(ap_ratio * pos_q, dim=1)
    num_pos = torch.sum(pos_q, dim=1)
    return ap_sum / (num_pos + 1e-8)


def s2r2_loss(embeddings: torch.Tensor,
              targets: Optional[torch.Tensor] = None, tau: float = 0.01,
              k_views: int = 3) -> torch.Tensor:
    """Smooth-AP over concatenated views [v1 of all; v2 of all; ...] (this
    rank's rows of each view under data parallelism; ``targets``, if given,
    theirs): loss = 1 - mean_q AP(q), AP from the sigmoid rank
    approximation, the mean over the global batch's queries. Computed in
    f32 whatever the input's dtype (``tau`` multiplies the similarities'
    rounding error by 1 / tau inside the sigmoid)."""
    e = embeddings.float()
    z = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-12)
    n, d = z.shape
    b, w = n // k_views, collectives.world()
    dev = z.device
    # every rank's views, (W * k, b, D) in rank order, to [v1 of all; v2 of
    # all; ...]; without a process group the same steps and no collective
    keys = collectives.all_gather(z.reshape(k_views, b, d))
    keys = keys.reshape(w, k_views, b, d).transpose(0, 1).reshape(-1, d)
    if targets is None:
        targets = torch.arange(w * b, device=dev).repeat(k_views)
    else:
        targets = collectives.all_gather(targets.reshape(k_views, b))
        targets = targets.reshape(w, k_views, b).transpose(0, 1).reshape(-1)
    # this rank's queries: their global rows, in the order they came in
    own = (torch.arange(k_views, device=dev)[:, None] * (w * b)
           + collectives.rank() * b + torch.arange(b, device=dev)).reshape(-1)
    sim = keys[own] @ keys.T                                  # (n, W n)
    eye = torch.nn.functional.one_hot(own, keys.shape[0]).float()
    pos_mask = (targets[own][:, None] == targets[None, :]).float() - eye
    all_mask = 1.0 - eye
    ap = [checkpoint(_ap_of_queries, sim[s:s + CHUNK], pos_mask[s:s + CHUNK],
                     all_mask[s:s + CHUNK], tau, use_reentrant=False)
          for s in range(0, n, CHUNK)]
    return 1.0 - collectives.global_mean(torch.cat(ap))
