"""Logistic-regression head and F1/accuracy metrics: the serving half of
``repro.core.classifier`` (``fit_logreg`` and ``kfold_cv`` come with
training).  The head is a plain ``x @ w + b`` outside any kernel, as the
reference leaves it to XLA."""
from __future__ import annotations

import numpy as np
import torch


def logreg_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def predict(params: dict, x) -> np.ndarray:
    x = torch.as_tensor(np.asarray(x, np.float32), device=params["w"].device)
    return torch.argmax(logreg_logits(params, x), dim=-1).cpu().numpy()


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> dict:
    """Returns micro/macro/weighted F1 and accuracy (one ``np.bincount``
    confusion matrix)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    cm = np.bincount(y_true * n_classes + y_pred,
                     minlength=n_classes * n_classes)
    cm = cm.reshape(n_classes, n_classes)        # rows: true, cols: pred
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    support = cm.sum(axis=1).astype(np.float64)
    denom = 2 * tp + fp + fn
    f1c = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    micro_d = 2 * tp.sum() + fp.sum() + fn.sum()
    return {
        "accuracy": float(tp.sum() / max(len(y_true), 1)),
        "f1_micro": float(2 * tp.sum() / micro_d) if micro_d else 0.0,
        "f1_macro": float(np.mean(f1c)),
        "f1_weighted": float(np.sum(f1c * support) / max(support.sum(), 1)),
        # binary convention (positive class = 1), used for UCI credit card
        "f1_binary": float(f1c[1]) if n_classes == 2 else float(np.mean(f1c)),
    }
