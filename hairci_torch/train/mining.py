"""Cluster-based hard-negative mining (port of ``hairci/train/mining.py``,
the device replacement of the reference's FAISS utilities,
``pretrain_engine.py:536-600``):

  estimate_k_by_pca   : the PCA eigen-spectrum of the covariance -> K (the
                        cumulative explained-variance rule);
  run_kmeans          : k-means++ seeding, then Lloyd iterations, each one
                        (N, K) distance product and one one-hot (K, N) x
                        (N, D) product for the new centroids (no atomics:
                        the same bits on every run);
  mine_hard_negatives : the second-nearest centroid of each anchor, then a
                        drawn pick among the 5 samples nearest that centroid,
                        a pick of the anchor itself replaced by the first.

Every random op is split as in the rest of the port: a draw half on a CPU
``torch.Generator`` (k-means++'s first index and its uniforms, the mining
offsets) and an apply half that takes them (``_kmeanspp_init`` samples by
inverse CDF from the drawn uniforms; ``_lloyd`` takes the initial indices,
``_mine`` the offsets), so a test can feed JAX's initial indices and
offsets. k-means++ cannot draw JAX's indices (``jax.random.choice`` with
``p``). Ties go to the lower index everywhere (stable sorts, ``argmin``'s
first minimum), as ``lax.top_k`` and ``jnp.argmin`` give them. Products
run in full f32 (no TF32). Tensors stay on the device they came on; numpy
input goes to ``device`` (cuda by default).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hairci_torch.eval.knn import full_f32_matmul
from hairci_torch.utils.device import DeviceLike, resolve_device


def _f32(X, device: DeviceLike = None) -> torch.Tensor:
    if isinstance(X, torch.Tensor) and device is None:
        return X.float()
    return torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor)
                           else X, dtype=torch.float32,
                           device=resolve_device(device))


def estimate_k_by_pca(X, explained_var_threshold: float = 0.9,
                      scale_factor: float = 2.0, max_k: int = 2000,
                      device: DeviceLike = None) -> Tuple[int, int]:
    """(K, m*): m* the number of leading eigenvalues of the covariance that
    explain ``explained_var_threshold`` of the variance (``searchsorted`` +
    1 on the descending cumulative ratio), K = ``scale_factor`` m* clipped
    to [5, min(max_k, N - 1)]."""
    X = _f32(X, device)
    N = X.shape[0]
    Xc = X - X.mean(dim=0, keepdim=True)
    with full_f32_matmul():
        cov = (Xc.T @ Xc) / max(N - 1, 1)
    eig = torch.clamp(torch.linalg.eigvalsh(cov).flip(0), min=0.0)
    ratio = eig / torch.clamp(eig.sum(), min=1e-12)
    cumulative = torch.cumsum(ratio, 0).cpu().numpy()
    m_star = int(np.searchsorted(cumulative, explained_var_threshold) + 1)
    k_est = int(np.clip(scale_factor * m_star, 5, min(max_k, N - 1)))
    return k_est, m_star


def _sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(N, K) squared L2 by the expanded form: one product and the norms."""
    with full_f32_matmul():
        prod = X @ C.T
    return (torch.sum(X * X, dim=1, keepdim=True) - 2.0 * prod
            + torch.sum(C * C, dim=1)[None])


def _lloyd(X: torch.Tensor, init_idx: torch.Tensor, k: int, niter: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``niter`` Lloyd iterations from the centroids ``X[init_idx]``; an
    empty cluster keeps its centroid (faiss). Returns (centroids (K, D),
    the last iteration's assignments (N,))."""
    centroids = X[init_idx.to(X.device)]
    assign = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for _ in range(niter):
        assign = torch.argmin(_sq_dists(X, centroids), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
        counts = onehot.sum(dim=0)
        with full_f32_matmul():
            sums = onehot.T @ X
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new_c, centroids)
    return centroids, assign


def draw_kmeanspp(gen: torch.Generator, N: int, k: int
                  ) -> Dict[str, torch.Tensor]:
    """The draw half of k-means++: the first index and k - 1 uniforms."""
    return {"first": torch.randint(0, N, (), generator=gen),
            "u": torch.rand(max(k - 1, 0), generator=gen, dtype=torch.float64)}


def _kmeanspp_init(X: torch.Tensor, draws: Dict[str, torch.Tensor],
                   k: int) -> torch.Tensor:
    """k-means++ seeding: each next seed sampled with probability
    proportional to its squared distance to the nearest seed so far, by
    inverse CDF from the drawn uniforms (on the device: no host sync)."""
    dev = X.device
    first = draws["first"].to(dev)
    idxs = [first]
    d2 = torch.sum((X - X[first]) ** 2, dim=1)
    u = draws["u"].to(dev)
    for i in range(k - 1):
        cdf = torch.cumsum(d2.double(), 0)
        nxt = torch.searchsorted(cdf, u[i] * cdf[-1], right=True)
        nxt = torch.clamp(nxt, max=X.shape[0] - 1)
        idxs.append(nxt)
        d2 = torch.minimum(d2, torch.sum((X - X[nxt]) ** 2, dim=1))
    return torch.stack(idxs)


def run_kmeans(X, k: int, niter: int = 20, seed: int = 0,
               device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means with k-means++ seeding from ``seed``; returns
    (centroids (K, D), assignments (N,))."""
    X = _f32(X, device)
    draws = draw_kmeanspp(torch.Generator().manual_seed(seed), X.shape[0], k)
    return _lloyd(X, _kmeanspp_init(X, draws, k), k, niter)


def _stable_smallest(d: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the ``n`` smallest entries of each row, ties to the lower
    index (``lax.top_k`` of ``-d``)."""
    return torch.sort(d, dim=1, stable=True).indices[:, :n]


def _mine(anchor: torch.Tensor, centroids: torch.Tensor,
          offs: torch.Tensor, topk: int = 5) -> torch.Tensor:
    """The apply half of the mining: ``offs`` (N,) in [0, topk) picks among
    the ``topk`` samples nearest each anchor's second-nearest centroid."""
    N = anchor.shape[0]
    d_ac = _sq_dists(anchor, centroids)                    # (N, K)
    neighbor_cid = _stable_smallest(d_ac, 2)[:, 1]
    samp_idx = _stable_smallest(d_ac.T, topk)              # (K, topk)
    cand = samp_idx[neighbor_cid]                          # (N, topk)
    hard = torch.gather(cand, 1, offs.to(anchor.device)[:, None])[:, 0]
    own = torch.arange(N, device=anchor.device)
    return torch.where(hard == own, cand[:, 0], hard)


def draw_mining(gen: torch.Generator, N: int, topk: int = 5) -> torch.Tensor:
    """The draw half of the mining: one offset in [0, topk) per anchor."""
    return torch.randint(0, topk, (N,), generator=gen)


def mine_hard_negatives(anchor, centroids, seed: int = 0, topk: int = 5,
                        device: DeviceLike = None) -> torch.Tensor:
    """Hard-negative ids (N,) per anchor by the second-nearest-centroid
    rule."""
    anchor = _f32(anchor, device)
    centroids = _f32(centroids, anchor.device)
    offs = draw_mining(torch.Generator().manual_seed(seed), anchor.shape[0],
                       topk)
    return _mine(anchor, centroids, offs, topk)
