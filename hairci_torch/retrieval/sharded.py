"""Row-sharded gallery search (port of ``hairci/retrieval/sharded.py``): a
gallery beyond one card's memory splits its rows over the ``data`` axis of
the mesh, one block a rank. Each rank searches its block with the top-k
kernel (``ops/topk.py``, the JAX ``use_pallas`` route; its plain twin on the
CPU), adds the block's first global row to the indices, and the ranks
all-gather their (Q, k) candidates; every rank then merges the W k
candidates by a stable lexsort, so the lower GLOBAL row index wins a tie,
as ``GalleryIndex`` breaks them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hairci_torch.eval.features import l2_normalize
from hairci_torch.eval.knn import full_f32_matmul
from hairci_torch.ops.topk import (
    MAX_K,
    topk_gallery_search,
    topk_gallery_search_reference,
)
from hairci_torch.parallel import DATA_AXIS, batch_sharding, collectives
from hairci_torch.utils.device import DeviceLike, resolve_device


def _merge_final(scores: torch.Tensor, indices: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, n_cand) -> top-k, descending, ties to the lower index: the
    lexsort on (index, -score) as two stable sorts."""
    by_index = torch.sort(indices, dim=1, stable=True).indices
    s = torch.gather(scores, 1, by_index)
    i = torch.gather(indices, 1, by_index)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), torch.gather(i, 1, order)


def sharded_gallery_search(mesh, queries: torch.Tensor,
                           gallery_shard: torch.Tensor, k: int = 5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (Q, k) scores and int64 indices of a row-sharded gallery.

    ``queries`` (Q, D) f32, normalised, the same on every rank;
    ``gallery_shard`` is this rank's block of the normalised (N, D) gallery
    along the mesh's ``data`` axis (``batch_sharding(mesh, 2).local``), N a
    multiple of the axis, so every block holds N / W rows. k is cut to a
    block's rows, as in JAX."""
    rows = gallery_shard.shape[0]
    k = min(k, rows)
    q = queries.float().contiguous()
    g = gallery_shard.contiguous()
    if k <= MAX_K:
        s, i = topk_gallery_search(q, g, k=k)
    else:
        with full_f32_matmul():
            s, i = topk_gallery_search_reference(q, g, k)
    i = i + mesh.coordinate(DATA_AXIS) * rows
    # one all-gather of both, f64 holding f32 scores and row indices
    # exactly: (2k, Q) a rank -> (W 2k, Q) in rank order -> (Q, W, 2k)
    both = torch.cat([s.double(), i.double()], 1).T
    both = collectives.all_gather(both, mesh.group(DATA_AXIS)).T
    both = both.reshape(q.shape[0], -1, 2 * k)
    return _merge_final(both[..., :k].reshape(q.shape[0], -1).float(),
                        both[..., k:].reshape(q.shape[0], -1).long(), k)


class ShardedGalleryIndex:
    """``GalleryIndex``-compatible facade over a mesh-sharded gallery: every
    rank holds its block of the normalised embeddings, zero rows padding
    the gallery to a multiple of the ``data`` axis."""

    def __init__(self, mesh, embeddings: np.ndarray, paths: Sequence[str],
                 normalized: bool = False, device: DeviceLike = None):
        self.mesh = mesh
        self.device = resolve_device(device)
        emb = np.asarray(embeddings, np.float32)
        self.n = emb.shape[0]
        pad = (-self.n) % mesh.shape[DATA_AXIS]
        if pad:
            # a zero row scores 0 against every query
            emb = np.concatenate([emb, np.zeros((pad, emb.shape[1]),
                                                np.float32)])
        shard = torch.as_tensor(batch_sharding(mesh, 2).local(emb),
                                device=self.device)
        # the rows are normalised one by one, so a block alone will do
        self.embeddings = (shard if normalized
                           else l2_normalize(shard)).contiguous()
        self.paths = list(paths)

    def __len__(self) -> int:
        return self.n

    def search(self, queries: np.ndarray, k: int = 5,
               normalized: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        if q.dim() == 1:
            q = q[None]
        if not normalized:
            q = l2_normalize(q)
        s, i = sharded_gallery_search(self.mesh, q, self.embeddings,
                                      k=min(k, self.n))
        # a padded row can only be a hit when every real score is negative:
        # rank such hits last, as JAX does
        s, i = s.cpu().numpy(), i.cpu().numpy()
        bad = i >= self.n
        s = np.where(bad, -np.inf, s)
        order = np.argsort(-s, axis=1, kind="stable")
        return (np.take_along_axis(s, order, axis=1),
                np.take_along_axis(np.where(bad, 0, i), order, axis=1))
