"""``Classifier`` facade (port of ``hairci/eval/classifier.py``): the
evaluation engine with the reference's API and artifact formats.
``knn_eval`` writes ``knn_evaluation_results.txt``, ``linear_probe_eval``
``linear_probe_results.txt``, ``save_umap`` ``umap_<split>.npz`` (and the
PNG where matplotlib imports), ``compute_intra_inter_variance``
``variance_analysis_<split>.txt``. Feature extraction runs on the device
with L2 normalization; the report text matches sklearn's.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from hairci_torch.eval.features import extract_features
from hairci_torch.eval.knn import DEFAULT_KS, knn_predict_multi
from hairci_torch.eval.linear_probe import linear_probe_fit_predict
from hairci_torch.eval.report import report
from hairci_torch.eval.umap_export import save_umap
from hairci_torch.eval.variance import (
    compute_intra_inter_variance,
    format_variance_report,
)
from hairci_torch.utils.device import DeviceLike, resolve_device


class Classifier:
    """Args mirror the JAX package: an ``embed_fn`` (uint8 image batch on the
    device -> features), train/test loaders, save_path."""

    def __init__(self, embed_fn, train_loader, test_loader, save_path: str,
                 batch_size: int = 256, device: DeviceLike = None):
        self.embed_fn = embed_fn
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.save_path = save_path
        self.batch_size = batch_size
        self.device = resolve_device(device)
        os.makedirs(save_path, exist_ok=True)
        self._cached = None

    def extracting_features(self):
        if self._cached is None:
            tr_f, tr_l = extract_features(
                self.embed_fn, iter(self.train_loader), self.batch_size,
                device=self.device)
            te_f, te_l = extract_features(
                self.embed_fn, iter(self.test_loader), self.batch_size,
                device=self.device)
            self._cached = (tr_f, tr_l, te_f, te_l)
        return self._cached

    def knn_eval(self, ks: Sequence[int] = DEFAULT_KS) -> dict:
        tr_f, tr_l, te_f, te_l = self.extracting_features()
        num_classes = int(max(tr_l.max(), te_l.max())) + 1
        path = os.path.join(self.save_path, "knn_evaluation_results.txt")
        with open(path, "w") as f:
            f.write("KNN Evaluation Results\n")
            f.write("=" * 50 + "\n\n")
        # all ks share one similarity matrix and one ordering per chunk
        all_preds = knn_predict_multi(tr_f, tr_l, te_f, ks, num_classes,
                                      device=self.device)
        results = {}
        for k in ks:
            acc, text, cm = report(te_l, all_preds[k])
            results[k] = acc
            with open(path, "a") as f:
                f.write(f"Results for k={k}\n")
                f.write("-" * 40 + "\n")
                f.write(f"Accuracy: {acc:.4f}\n\n")
                f.write("Classification Report:\n")
                f.write(text + "\n\n")
                f.write("Confusion Matrix:\n")
                f.write(np.array2string(cm) + "\n\n")
                f.write("=" * 50 + "\n\n")
        return results

    def linear_probe_eval(self, backend: str = "torch") -> float:
        tr_f, tr_l, te_f, te_l = self.extracting_features()
        num_classes = int(max(tr_l.max(), te_l.max())) + 1
        preds = linear_probe_fit_predict(tr_f, tr_l, te_f, num_classes,
                                         backend=backend, device=self.device)
        acc, text, cm = report(te_l, preds)
        path = os.path.join(self.save_path, "linear_probe_results.txt")
        with open(path, "w") as f:
            f.write("Linear Probe Evaluation Results\n")
            f.write("=" * 50 + "\n\n")
            f.write(f"Accuracy: {acc:.4f}\n\n")
            f.write("Classification Report:\n")
            f.write(text + "\n\n")
            f.write("Confusion Matrix:\n")
            f.write(np.array2string(cm) + "\n\n")
            f.write("=" * 50 + "\n\n")
        return acc

    def _split(self, split: str):
        tr_f, tr_l, te_f, te_l = self.extracting_features()
        if split == "train":
            return tr_f, tr_l
        if split == "test":
            return te_f, te_l
        return np.concatenate([tr_f, te_f]), np.concatenate([tr_l, te_l])

    def save_umap(self, split: str = "both", **kw) -> str:
        f, l = self._split(split)
        return save_umap(f, l, self.save_path, filename=f"umap_{split}.png",
                         device=self.device, **kw)

    def compute_intra_inter_variance(self, split: str = "test") -> dict:
        results = compute_intra_inter_variance(*self._split(split))
        path = os.path.join(self.save_path, f"variance_analysis_{split}.txt")
        with open(path, "w") as fo:
            fo.write(format_variance_report(results))
        return results
