"""Linear probe (port of ``hairci/eval/linear_probe.py``): multinomial
logistic regression on frozen features, the objective of the reference's
sklearn ``LogisticRegression(solver="lbfgs")`` at C = 1:

    mean CE(X W + b, y) + ||W||^2 / (2 C N)      (the bias not regularised)

fitted full batch on the device in full f32 (no TF32), from zero ``W`` and
``b``, by L-BFGS with a memory of 10 and a strong-Wolfe line search
(``torch.optim.LBFGS``; the JAX package runs ``optax.lbfgs`` with its
zoom search for a fixed 500 iterations). The objective is strictly convex,
so both land on the same minimiser. ``torch.optim.LBFGS`` also stops early
once the gradient or the change of the objective vanishes in f32.
``backend="sklearn"`` is the oracle, on the CPU only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hairci_torch.eval.knn import full_f32_matmul
from hairci_torch.utils.device import DeviceLike, resolve_device


def objective(W: torch.Tensor, b: torch.Tensor, X: torch.Tensor,
              y: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    """mean CE + ||W||^2 / (2 C N)."""
    ce = F.cross_entropy(X @ W + b, y)
    return ce + 0.5 / (C * X.shape[0]) * torch.sum(W * W)


def fit_lbfgs(X: torch.Tensor, y: torch.Tensor, num_classes: int,
              max_iter: int = 500, C: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, float]]:
    """(W (D, K), b (K,), info) of the probe fitted on ``X`` (N, D) f32 and
    ``y`` (N,) int64 on their device; ``info`` holds the final objective,
    the iterations and the objective evaluations."""
    D = X.shape[1]
    W = torch.zeros(D, num_classes, device=X.device, requires_grad=True)
    b = torch.zeros(num_classes, device=X.device, requires_grad=True)
    opt = torch.optim.LBFGS([W, b], lr=1.0, max_iter=max_iter,
                            max_eval=20 * max_iter, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = objective(W, b, X, y, C)
        loss.backward()
        return loss

    with full_f32_matmul():
        opt.step(closure)
        with torch.no_grad():
            final = float(objective(W, b, X, y, C))
    st = opt.state[opt._params[0]]
    info = {"objective": final, "iterations": int(st["n_iter"]),
            "evaluations": int(st["func_evals"])}
    return W.detach(), b.detach(), info


def linear_probe_fit_predict(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    num_classes: int | None = None,
    backend: str = "torch",
    max_iter: int = 500,
    device: DeviceLike = None,
) -> np.ndarray:
    """Fit the probe and return the test predictions (argmax of the
    logits)."""
    if num_classes is None:
        num_classes = int(train_labels.max()) + 1
    if backend == "sklearn":
        from sklearn.linear_model import LogisticRegression

        clf = LogisticRegression(max_iter=5000, solver="lbfgs")
        clf.fit(train_features, train_labels)
        return clf.predict(test_features)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    X = torch.as_tensor(np.asarray(train_features, np.float32), device=device)
    y = torch.as_tensor(np.asarray(train_labels, np.int64), device=device)
    W, b, _ = fit_lbfgs(X, y, num_classes, max_iter)
    Xt = torch.as_tensor(np.asarray(test_features, np.float32), device=device)
    with full_f32_matmul():
        return (Xt @ W + b).argmax(dim=1).cpu().numpy()


def linear_probe_eval(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    test_labels: np.ndarray,
    backend: str = "torch",
    device: DeviceLike = None,
) -> Dict:
    num_classes = int(max(train_labels.max(), test_labels.max())) + 1
    preds = linear_probe_fit_predict(
        train_features, train_labels, test_features, num_classes, backend,
        device=device)
    acc = float(np.mean(preds == test_labels))
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (test_labels.astype(np.int64), preds.astype(np.int64)), 1)
    return {"accuracy": acc, "predictions": preds, "confusion_matrix": cm}
