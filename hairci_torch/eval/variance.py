"""Embedding geometry (port of ``hairci/eval/variance.py``), the reference's
``Classifier.compute_intra_inter_variance``:

  intra = mean over classes of E[||x - class_mean||^2]
  inter = mean over classes of ||class_mean - global_mean||^2
  ratio = inter / (intra + 1e-8)
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_intra_inter_variance(features: np.ndarray,
                                 labels: np.ndarray) -> Dict[str, float]:
    features = np.asarray(features)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    global_mean = features.mean(axis=0)
    intra, inter = 0.0, 0.0
    for c in classes:
        feats = features[labels == c]
        mean = feats.mean(axis=0)
        intra += float(np.mean(np.sum((feats - mean) ** 2, axis=1)))
        inter += float(np.sum((mean - global_mean) ** 2))
    intra /= len(classes)
    inter /= len(classes)
    return {
        "intra_class_variance": intra,
        "inter_class_variance": inter,
        "variance_ratio": inter / (intra + 1e-8),
    }


def format_variance_report(results: Dict[str, float]) -> str:
    lines = ["Embedding Geometry Analysis", "=" * 50]
    lines += [f"{k}: {v:.6f}" for k, v in results.items()]
    return "\n".join(lines) + "\n"
