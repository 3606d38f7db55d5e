"""Accuracy, classification report and confusion matrix in numpy, with the
text layout of ``sklearn.metrics`` (which the JAX package's ``Classifier``
calls): the port's result files are the same bytes without needing sklearn.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (``zero_division=0``)."""
    num, den = np.asarray(num, dtype=np.float64), np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def confusion_matrix(y_true, y_pred) -> np.ndarray:
    """Rows: true label, columns: predicted, over the sorted labels that
    occur in either (int64)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    cm = np.zeros((labels.size, labels.size), dtype=np.int64)
    np.add.at(cm, (np.searchsorted(labels, y_true),
                   np.searchsorted(labels, y_pred)), 1)
    return cm


def accuracy_score(y_true, y_pred) -> float:
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def classification_report(y_true, y_pred, digits: int = 2) -> str:
    """``sklearn.metrics.classification_report(..., zero_division=0)`` for
    single-label integer classes."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    cm = confusion_matrix(y_true, y_pred)
    tp = np.diag(cm).astype(np.float64)
    pred_sum, support = cm.sum(0), cm.sum(1)
    p, r = _divide(tp, pred_sum), _divide(tp, support)
    f1 = _divide(2 * tp, support + pred_sum)
    names = [f"{label}" for label in labels]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    headers = ["precision", "recall", "f1-score", "support"]
    report = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, support):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    total = np.sum(support)
    # micro average == accuracy for single-label classes
    micro = _divide(tp.sum(), pred_sum.sum())
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n").format("accuracy", "", "", float(micro), total,
                                    width=width, digits=digits)
    report += row_fmt.format("macro avg", np.average(p), np.average(r),
                             np.average(f1), total, width=width, digits=digits)
    if total:
        weighted = [float(np.average(v, weights=support)) for v in (p, r, f1)]
    else:
        weighted = [0.0, 0.0, 0.0]
    report += row_fmt.format("weighted avg", *weighted, total, width=width,
                             digits=digits)
    return report


def report(y_true, y_pred) -> Tuple[float, str, np.ndarray]:
    """(accuracy, classification report, confusion matrix)."""
    return (accuracy_score(y_true, y_pred),
            classification_report(y_true, y_pred),
            confusion_matrix(y_true, y_pred))
