"""Logistic-regression probe (paper Sec. 5, linear probing), k-fold
cross-validation and F1/accuracy metrics: the port of
``repro.core.classifier``.

``kfold_cv`` treats the k folds as lanes of one fit: every fold carries a
full-row 0/1 weight vector (zero on its own test rows) and all k probes
advance together through ``steps`` Adam steps.  With ``use_kernel=False``
the step is one closed-form gradient over the shared ``x`` whose fold
axis is a column block of a single GEMM pair (``_probe_grads_blocked``,
plain ``torch.matmul``, as the reference leaves it to XLA); with
``use_kernel=True`` every step is ONE launch of the probe kernel over the
k fold lanes (``kernels.ops.probe_grad_step``).  Zero-weight rows are
exactly inert, so padding and held-out rows change nothing.  The probes
start from zeros.  The head itself is a plain ``x @ w + b``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import padding
from repro_torch.kernels import ops as kops
from repro_torch.optim.adam import paper_adam


def init_logreg(n_features: int, n_classes: int, *, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"w": torch.zeros((n_features, n_classes), device=dev),
            "b": torch.zeros((n_classes,), device=dev)}


def logreg_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _ce_terms(params: dict, x, y):
    logits = logreg_logits(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return lse - gold, 1e-4 * torch.sum(torch.square(params["w"]))


def logreg_loss(params: dict, batch: dict) -> torch.Tensor:
    ce, l2 = _ce_terms(params, batch["x"], batch["y"])
    return torch.mean(ce) + l2


def _weighted_logreg_loss(params, x, y, w) -> torch.Tensor:
    """``logreg_loss`` with per-row weights: with 0/1 weights the weighted
    mean over real rows equals the plain mean over those rows exactly."""
    ce, l2 = _ce_terms(params, x, y)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0) + l2


def _as_rows(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def fit_logreg(x, y, n_classes: int, steps: int = 300, lr: float = 0.1,
               use_kernel: bool = False) -> dict:
    """Full-batch Adam logistic regression on the device of ``x`` (a
    tensor).  ``use_kernel=True`` takes each step's gradient from the
    probe kernel (all-ones row weights make the weighted CE the plain
    mean); otherwise autograd of ``logreg_loss``."""
    dev = x.device
    y = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor)
                        else y, device=dev).long()
    params = {"w": torch.zeros((x.shape[1], n_classes), device=dev),
              "b": torch.zeros((n_classes,), device=dev)}
    opt = paper_adam(lr)
    state = opt.init(params)
    ones = torch.ones((x.shape[0],), device=dev)
    y32 = y.to(torch.int32)
    for _ in range(steps):
        if use_kernel:
            _, dw, db = kops.probe_grad_step(params["w"], params["b"], x,
                                             y32, ones)
        else:
            with torch.enable_grad():
                w, b = (t.detach().requires_grad_(True)
                        for t in (params["w"], params["b"]))
                dw, db = torch.autograd.grad(
                    logreg_loss({"w": w, "b": b}, {"x": x, "y": y}), (w, b))
        with torch.no_grad():
            params, state = opt.update({"w": dw, "b": db}, state, params)
    return params


def _probe_grads_blocked(w, b, x, onehot, rw, *, l2: float = 1e-4):
    """Closed-form weighted softmax-CE gradient for ALL k fold probes in
    one pass over the shared ``x``: ``w`` (k, d, C), ``b`` (k, C), ``x``
    (n, d), ``onehot`` (n, C), ``rw`` (n, k) per-fold normalized row
    weights.  Matches autodiff of ``_weighted_logreg_loss``."""
    k, d, c = w.shape
    w2 = w.permute(1, 0, 2).reshape(d, k * c)
    logits = (x @ w2).reshape(-1, k, c) + b[None]
    g = (torch.softmax(logits, dim=-1) - onehot[:, None, :]) \
        * rw[:, :, None]
    dw = (x.T @ g.reshape(-1, k * c)).reshape(d, k, c).permute(1, 0, 2)
    return dw + 2.0 * l2 * w, torch.sum(g, dim=0)


def _fit_predict_folds(x, y, tr_idx, tr_w, te_idx, *, n_classes: int,
                       steps: int = 300, lr: float = 0.1,
                       use_kernel: bool = False) -> torch.Tensor:
    """All k probe fits plus test-fold predictions, fold-blocked.
    ``tr_idx``/``te_idx`` are (k, max_tr)/(k, max_te) row indices into
    ``x`` (padded entries point at row 0), ``tr_w`` the matching 0/1
    weights.  Returns (k, max_te) predicted labels."""
    n, d = x.shape
    k = tr_idx.shape[0]
    dev = x.device
    rw_full = torch.zeros((k, n), device=dev).scatter_add_(
        1, tr_idx.long(), tr_w)                                  # (k, n)
    denom = torch.clamp(torch.sum(tr_w, dim=1), min=1.0)         # (k,)
    rw = (rw_full / denom[:, None]).T                            # (n, k)
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(
        torch.float32)
    y32 = y.to(torch.int32)
    params = {"w": torch.zeros((k, d, n_classes), device=dev),
              "b": torch.zeros((k, n_classes), device=dev)}
    opt = paper_adam(lr)
    state = opt.init(params)
    for _ in range(steps):
        if use_kernel:
            # one launch for all k fold lanes; the wrapper normalizes by
            # sum(rw) == denom for 0/1 weights
            _, dw, db = kops.probe_grad_step(params["w"], params["b"], x,
                                             y32, rw_full)
        else:
            dw, db = _probe_grads_blocked(params["w"], params["b"], x,
                                          onehot, rw)
        params, state = opt.update({"w": dw, "b": db}, state, params)
    logits = torch.einsum("ked,kdc->kec", x[te_idx.long()], params["w"]) \
        + params["b"][:, None, :]
    return torch.argmax(logits, dim=-1)


def predict(params: dict, x) -> np.ndarray:
    x = torch.as_tensor(np.asarray(x, np.float32), device=params["w"].device)
    return torch.argmax(logreg_logits(params, x), dim=-1).cpu().numpy()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

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


def _fold_arrays(n: int, k: int, seed: int):
    """The paper's fold assignment (seeded permutation + ``array_split``)
    as padded index arrays: (k, max_tr) train indices + 0/1 weights
    (padded slots gather row 0 at zero weight) and (k, max_te) test
    indices, plus the raw folds for host-side metric slicing."""
    perm = np.random.RandomState(seed).permutation(n)
    folds = np.array_split(perm, k)
    te_lens = [len(f) for f in folds]
    trs = [np.concatenate([folds[j] for j in range(k) if j != i])
           for i in range(k)]
    tr_idx, tr_w = padding.pad_index_rows(trs)
    te_idx, _ = padding.pad_index_rows(folds)
    return tr_idx, tr_w, te_idx, folds, te_lens


def kfold_cv(x, y, n_classes: int, *, k: int = 10, seed: int = 0,
             use_kernel: bool = False, device="cuda") -> dict:
    """Paper evaluation: k-fold CV of the logistic probe; mean metrics.
    The k fits run fold-blocked on ``device`` (module docstring), with a
    single host sync for all predictions."""
    with torch.no_grad():
        dev = resolve_device(device)
        x = _as_rows(x, dev)
        y = np.asarray(y)
        tr_idx, tr_w, te_idx, folds, te_lens = _fold_arrays(len(x), k, seed)
        put = lambda a: torch.as_tensor(a, device=dev)
        preds = _fit_predict_folds(
            x, put(y), put(tr_idx), put(tr_w), put(te_idx),
            n_classes=n_classes, use_kernel=use_kernel).cpu().numpy()
    accs = [f1_scores(y[folds[i]], preds[i, :te_lens[i]], n_classes)
            for i in range(k)]
    return {k_: float(np.mean([a[k_] for a in accs])) for k_ in accs[0]}


def kfold_cv_many(xs, ys, n_classes: int, *, k: int = 10, seeds,
                  use_kernel: bool = False, device="cuda") -> list:
    """S independent k-fold CVs, one per seed: one metrics dict per seed,
    each ``kfold_cv(xs[i], ys[i], ..., seed=seeds[i])``.  The reference
    vmaps the seeds into one call; here each seed's folds are one
    fold-blocked fit (one probe launch per step with ``use_kernel``)."""
    return [kfold_cv(x, y, n_classes, k=k, seed=int(s),
                     use_kernel=use_kernel, device=device)
            for x, y, s in zip(xs, ys, seeds)]
