"""kNN classification on the device (port of ``hairci/eval/knn.py``).

Cosine similarity over L2-normalized features is one (Nq, Ng) product in
full f32, followed by an ordering of each row and a vote. Ties as in the JAX
package (and sklearn):
  * equal similarities -> the lower gallery index wins;
  * equal vote counts  -> the lower class id wins (argmax returns the first
    maximum).
``torch.topk`` promises no order among equal scores, so the neighbours come
from ``ordered_neighbours``: ``torch.topk`` with the ties put right, or, as
the reference it is tested against, one stable sort of every row.
Large query sets go through in chunks, to bound the score matrix.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from hairci_torch.eval.features import l2_normalize
from hairci_torch.utils.device import DeviceLike, resolve_device

DEFAULT_KS: Tuple[int, ...] = (5, 10, 20, 27, 30, 40, 642)


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32 whatever the caller's global setting: a TF32
    product (about three decimal digits) swaps k-th and (k+1)-th neighbours
    whose gap is ~1e-5 at a 100k gallery."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


@contextlib.contextmanager
def full_f32(dtype: str):
    """``--dtype float32`` means full f32 on the card for the run: cuDNN's
    convolutions (which allow TF32 by default) and f32 matmuls without TF32,
    as layer1's conv3x3 kernel and the kNN compute. The flags are restored
    afterwards; bf16 runs are left as they are."""
    if dtype != "float32":
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with full_f32_matmul():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def similarities(query: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():
        return query @ gallery.T


def ordered_neighbours(sims: torch.Tensor, k: int,
                       method: str = "topk") -> torch.Tensor:
    """(Q, k) indices of each row's k largest scores, by (score descending,
    index ascending): what ``lax.top_k`` returns.

    ``topk``: ``torch.topk`` picks the k largest, two stable sorts of the
    (Q, k) candidates put equal scores in index order, and rows where a
    score equal to the k-th was left outside (``topk`` may keep any of them)
    are redone by the full sort. ``sort``: one stable descending sort of
    every row, the reference for the other (3.5 times its time at 4096 x
    103,945 scores and k = 642 on an H100).
    """
    if method == "sort":
        return torch.sort(sims, dim=1, descending=True,
                          stable=True).indices[:, :k]
    if method != "topk":
        raise ValueError(f"unknown method {method!r}")
    vals, idx = torch.topk(sims, k, dim=1)
    by_index = torch.sort(idx, dim=1, stable=True)
    vals = vals.gather(1, by_index.indices)
    by_score = torch.sort(vals, dim=1, descending=True, stable=True)
    idx = by_index.values.gather(1, by_score.indices)
    kth = by_score.values[:, -1:]
    left_out = (sims == kth).sum(1) != (by_score.values == kth).sum(1)
    rows = left_out.nonzero()[:, 0]
    if rows.numel():
        idx[rows] = ordered_neighbours(sims[rows], k, "sort")
    return idx


def _vote(votes: torch.Tensor, ks: Sequence[int],
          num_classes: int) -> Tuple[torch.Tensor, ...]:
    """Per k (ascending), the class with most votes among the first k
    columns of ``votes``; each k adds its own columns to one running count."""
    counts = torch.zeros((votes.shape[0], num_classes), dtype=torch.float32,
                         device=votes.device)
    preds, prev = [], 0
    for k in ks:
        block = votes[:, prev:k]
        counts.scatter_add_(1, block, torch.ones_like(block,
                                                      dtype=torch.float32))
        prev = k
        preds.append(counts.argmax(dim=1).to(torch.int32))
    return tuple(preds)


def _prepare(train_features, train_labels, normalized, device):
    gallery = torch.as_tensor(np.asarray(train_features), dtype=torch.float32
                              ).to(device)
    labels = torch.as_tensor(np.asarray(train_labels).astype(np.int64)
                             ).to(device)
    return (gallery if normalized else l2_normalize(gallery)), labels


def _chunks(test_features, chunk, normalized, device):
    for start in range(0, test_features.shape[0], chunk):
        q = torch.as_tensor(np.asarray(test_features[start:start + chunk]),
                            dtype=torch.float32).to(device)
        yield q if normalized else l2_normalize(q)


def knn_predict(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    k: int,
    num_classes: int | None = None,
    chunk: int = 4096,
    normalized: bool = True,
    device: DeviceLike = None,
) -> np.ndarray:
    """Predicted labels for every test row (classes are raw int ids)."""
    return knn_predict_multi(train_features, train_labels, test_features,
                             (k,), num_classes, chunk, normalized,
                             device)[k]


@torch.no_grad()
def knn_predict_multi(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    ks: Sequence[int],
    num_classes: int | None = None,
    chunk: int = 4096,
    normalized: bool = True,
    device: DeviceLike = None,
) -> Dict[int, np.ndarray]:
    """Predictions for every k over one shared similarity matrix and one
    ordering per query chunk: ks are clipped to N and deduplicated, and each
    k votes over a prefix of the ordered neighbour list."""
    device = resolve_device(device)
    if num_classes is None:
        num_classes = int(max(train_labels.max(), 0)) + 1
    n = train_features.shape[0]
    clipped = {k: min(k, n) for k in ks}
    uniq = tuple(sorted(set(clipped.values())))
    gallery, labels = _prepare(train_features, train_labels, normalized,
                               device)
    per_k = [[] for _ in uniq]
    for q in _chunks(test_features, chunk, normalized, device):
        idx = ordered_neighbours(similarities(q, gallery), uniq[-1])
        for buf, o in zip(per_k, _vote(labels[idx], uniq, num_classes)):
            buf.append(o)
    stacked = {k: torch.cat(b).cpu().numpy() for k, b in zip(uniq, per_k)}
    return {k: stacked[clipped[k]] for k in ks}


def knn_eval(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    test_labels: np.ndarray,
    ks: Sequence[int] = DEFAULT_KS,
    num_classes: int | None = None,
    device: DeviceLike = None,
) -> Dict[int, Dict]:
    """Accuracy, confusion matrix and predictions per k; all ks share one
    pass per query chunk (``knn_predict_multi``)."""
    if num_classes is None:
        num_classes = int(max(train_labels.max(), test_labels.max())) + 1
    all_preds = knn_predict_multi(train_features, train_labels,
                                  test_features, ks, num_classes,
                                  device=device)
    results = {}
    for k in ks:
        preds = all_preds[k]
        cm = np.zeros((num_classes, num_classes), dtype=np.int64)
        np.add.at(cm, (test_labels.astype(np.int64), preds.astype(np.int64)),
                  1)
        results[k] = {"accuracy": float(np.mean(preds == test_labels)),
                      "confusion_matrix": cm, "predictions": preds}
    return results


def format_knn_report(results: Dict[int, Dict]) -> str:
    """One line per k: ``k=<k>: accuracy=<acc>``."""
    return "\n".join(f"k={k}: accuracy={r['accuracy']:.4f}"
                     for k, r in sorted(results.items())) + "\n"
