"""Gallery index (port of ``hairci/retrieval/index.py``).

A flat inner-product index over L2-normalised embeddings held on the device:

    scores = queries @ gallery^T   (f32 accumulation)
    top-k  = stable, ties to the lower gallery index

For k <= 8 with the kernel on, search is the hand-written CUDA kernel
(``hairci_torch/ops/topk.py``), which never writes the (Q, N) score matrix.
Otherwise the gallery is scored in chunks with ``torch.matmul`` in full f32
(whatever the caller's global matmul precision, as the kernel and the kNN
do) and the per-chunk top-k are merged, so memory holds one (Q, chunk) tile
at a time.
The kernel masks its own ragged edge, so the gallery is stored unpadded.
Persistence is ``embeddings.npy`` + ``image_paths.txt``, byte-compatible with
the JAX package: an index saved by one loads in the other.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hairci_torch.eval.features import l2_normalize
from hairci_torch.eval.knn import full_f32_matmul
from hairci_torch.ops.topk import topk_gallery_search
from hairci_torch.utils.device import DeviceLike, resolve_device
from hairci_torch.utils.profiling import span

KERNEL_MAX_K = 8


def _stable_topk(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with ties to the lower position."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


class GalleryIndex:
    """Flat inner-product index over L2-normalised embeddings."""

    def __init__(self, embeddings: np.ndarray, paths: Sequence[str],
                 normalized: bool = False, chunk: int = 65536,
                 use_kernel: Optional[bool] = None,
                 storage_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        """``storage_dtype=torch.bfloat16`` halves device memory and the
        bytes a search reads; scores still accumulate in f32."""
        self.device = resolve_device(device)
        emb = torch.as_tensor(np.asarray(embeddings, np.float32),
                              device=self.device)
        if not normalized:
            emb = l2_normalize(emb)
        self.embeddings = emb.to(storage_dtype).contiguous()
        self.n = int(emb.shape[0])
        self.paths = list(paths)
        self.chunk = chunk
        # the CUDA top-k kernel (counterpart of use_pallas)
        self.use_kernel = (self.device.type == "cuda" if use_kernel is None
                           else use_kernel)

    def __len__(self) -> int:
        return self.n

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    # ------------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int = 5,
               normalized: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k) cosine sim desc, indices (Q, k) int64)."""
        rows = len(queries) if np.ndim(queries) > 1 else 1
        with span("search", rows, self.device):
            q = torch.as_tensor(np.asarray(queries, np.float32),
                                device=self.device)
            if q.dim() == 1:
                q = q[None]
            if not normalized:
                q = l2_normalize(q)
            q = q.contiguous()
            n = len(self)
            k = min(k, n)
            if self.use_kernel and k <= KERNEL_MAX_K:
                s, i = topk_gallery_search(q, self.embeddings, k=k)
                return s.cpu().numpy(), i.cpu().numpy()
            scores = indices = None
            for start in range(0, n, self.chunk):
                block = self.embeddings[start:min(start + self.chunk, n)]
                with full_f32_matmul():
                    s = torch.matmul(q, block.float().T)
                s, i = _stable_topk(s, min(k, block.shape[0]))
                i = i + start
                if scores is None:
                    scores, indices = s, i
                else:
                    # running entries come first, so equal scores keep the
                    # lower gallery index
                    scores, pos = _stable_topk(torch.cat([scores, s], 1), k)
                    indices = torch.gather(torch.cat([indices, i], 1),
                                           1, pos)
            return scores.cpu().numpy(), indices.cpu().numpy()

    def search_paths(self, queries: np.ndarray, k: int = 5
                     ) -> Tuple[np.ndarray, List[List[str]]]:
        scores, idx = self.search(queries, k)
        return scores, [[self.paths[j] for j in row] for row in idx]

    # ------------------------------------------------------------------
    def save(self, out_dir: str, prefix: str = "") -> None:
        """``embeddings.npy`` (f32) + ``image_paths.txt``."""
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{prefix}embeddings.npy"),
                self.embeddings.float().cpu().numpy())
        with open(os.path.join(out_dir, f"{prefix}image_paths.txt"), "w") as f:
            f.write("\n".join(self.paths) + "\n")

    @classmethod
    def load(cls, out_dir: str, prefix: str = "", device: DeviceLike = None,
             **kw) -> "GalleryIndex":
        emb = np.load(os.path.join(out_dir, f"{prefix}embeddings.npy"))
        with open(os.path.join(out_dir, f"{prefix}image_paths.txt")) as f:
            paths = [line for line in f.read().splitlines() if line]
        return cls(emb, paths, normalized=True, device=device, **kw)

    @classmethod
    def exists(cls, out_dir: str, prefix: str = "") -> bool:
        return (os.path.exists(os.path.join(out_dir, f"{prefix}embeddings.npy"))
                and os.path.exists(
                    os.path.join(out_dir, f"{prefix}image_paths.txt")))
