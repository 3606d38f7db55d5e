"""Batched feature extraction (port of ``hairci/eval/features.py``):
``embed_fn`` over a loader, L2-normalized, gathered on the host.

Every call of ``embed_fn`` sees the same batch shape: the last batch is
padded by repeating its last image and the padding rows are dropped. The
features stay on the device until the loader is exhausted, so the host never
waits for the card between batches.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from hairci_torch.aug.ops import to_device
from hairci_torch.utils.device import DeviceLike, resolve_device


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize parity over the last axis:
    x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


@torch.no_grad()
def extract_features(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    normalize: bool = True,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``embed_fn`` (image batch on ``device`` -> (B, D)) over
    ``batches`` of numpy (images, labels), with grad mode off. Returns
    (features (N, D) f32, labels (N,)) on the host. ``embed_fn`` should
    already include the eval transform and hold its model in eval mode."""
    device = resolve_device(device)
    feats, labels = [], []
    for images, lbls in batches:
        n = images.shape[0]
        if n < batch_size:
            images = np.concatenate(
                [images, np.repeat(images[-1:], batch_size - n, axis=0)])
        out = embed_fn(to_device(torch.from_numpy(images), device))
        if normalize:
            out = l2_normalize(out)
        feats.append(out[:n].float())
        labels.append(np.asarray(lbls))
    return (torch.cat(feats).cpu().numpy(), np.concatenate(labels, axis=0))
