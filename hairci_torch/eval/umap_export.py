"""2-D embedding projection (port of ``hairci/eval/umap_export.py``), the
reference's ``Classifier.save_umap``: UMAP with the reference's parameters
where ``umap`` imports, else PCA on the device (the feature covariance in
full f32, ``torch.linalg.eigh``, the two leading eigenvectors in the JAX
package's order). ``save_umap`` writes the coordinates and labels as
``.npz``, and the scatter PNG where matplotlib imports.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hairci_torch.eval.knn import full_f32_matmul
from hairci_torch.utils.device import DeviceLike, resolve_device


def project_2d(features: np.ndarray, n_neighbors: int = 15,
               min_dist: float = 0.1, metric: str = "cosine",
               random_state: int = 42, device: DeviceLike = None
               ) -> np.ndarray:
    try:
        import umap  # type: ignore
    except ImportError:
        return pca_2d(features, device)
    reducer = umap.UMAP(n_neighbors=n_neighbors, min_dist=min_dist,
                        metric=metric, random_state=random_state)
    return np.asarray(reducer.fit_transform(features))


def pca_2d(features: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """(N, 2) coordinates on the two leading principal axes, the first
    axis first (each axis' sign is eigh's)."""
    x = torch.as_tensor(np.asarray(features, np.float32),
                        device=resolve_device(device))
    x = x - x.mean(dim=0, keepdim=True)
    with full_f32_matmul():
        cov = (x.T @ x) / max(x.shape[0] - 1, 1)
        _, eigvecs = torch.linalg.eigh(cov)
        top2 = eigvecs[:, -2:].flip(1)
        return (x @ top2).cpu().numpy()


def save_umap(features: np.ndarray, labels: np.ndarray, save_path: str,
              filename: str = "umap.png", point_size: int = 5,
              alpha: float = 0.8, device: DeviceLike = None, **kw) -> str:
    coords = project_2d(features, device=device, **kw)
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, filename)
    np.savez(out.replace(".png", ".npz"), coords=coords, labels=labels)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return out
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(coords[:, 0], coords[:, 1], c=labels, s=point_size,
                    alpha=alpha, cmap="tab20")
    fig.colorbar(sc, ax=ax)
    ax.set_title("Embedding projection")
    fig.savefig(out, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return out
