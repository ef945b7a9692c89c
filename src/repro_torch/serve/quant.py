"""Int8-quantized serving for the active-only path ``head(g3(x))``: the
port of ``repro.serve.quant``.

* **per-channel symmetric quantization** — each weight matrix ``w`` is
  stored as ``w_q = round(w / scale)`` in int8 with one fp32 ``scale``
  per OUTPUT channel (``scale[c] = max|w[:, c]| / 127``), computed in
  numpy exactly as the reference does, so both packages hold the same
  bytes.  Biases and the feature scaler stay fp32.

* **the kernel path** — ``int8_active_apply`` runs the quantized predict
  as three launches of the int8 matmul kernel (``kernels.ops.int8_matmul``):
  the dequant happens in registers (weights cross memory at 1 byte a
  parameter) and the hidden SELU is fused into the first launch.  The
  serving engine takes this path on CUDA.

* **the CPU path** — on the CPU the engine serves from weights
  dequantized once at init (``dequantized_active_params``), as the
  reference engine does; both compute ``x @ (w_q * scale) + b`` in fp32.

``parity_report`` measures the int8-vs-fp32 gap; the pinned bounds below
are the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops

# pinned int8-vs-fp32 agreement bounds (repro/serve/quant.py)
MAX_LOGIT_DELTA = 0.8
MAX_REL_LOGIT_DELTA = 0.12
MAX_F1_DELTA = 0.04


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def quantize_weight(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: (w_q int8 (d, c), scale (c,)).
    All-zero columns get scale 1.0 (they dequantize back to exact zeros)."""
    w = _host(w).astype(np.float32)
    if w.ndim != 2:
        raise ValueError(f"quantize_weight: expected a 2-D weight, "
                         f"got shape {w.shape}")
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return w_q, scale


def dequantize_weight(w_q, scale) -> np.ndarray:
    return (_host(w_q).astype(np.float32)
            * _host(scale).astype(np.float32)[None, :])


def _enc_layers(g3: dict) -> dict:
    enc = g3["enc"] if "enc" in g3 else g3
    n = len([k for k in enc if k.startswith("w")])
    if n != 2:
        raise ValueError(f"int8 serving supports the 2-layer Table-3 "
                         f"student; this g3 encoder has {n} layers")
    return enc


def quantize_active_path(bundle, *, device="cuda") -> Dict:
    """Quantize the active-only serving params (g3 encoder + head) of a
    ``ModelBundle`` into a flat dict of int8 weights + fp32 scales/biases
    on ``device``, with the feature scaler carried along."""
    dev = resolve_device(device)
    enc = _enc_layers(bundle.g3)
    w0_q, w0_s = quantize_weight(enc["w0"])
    w1_q, w1_s = quantize_weight(enc["w1"])
    hw_q, hw_s = quantize_weight(bundle.head_active["w"])
    scale = np.asarray(bundle.x_scale, np.float32)
    fp32_bytes = sum(int(_host(v).size) * 4
                     for v in (enc["w0"], enc["w1"],
                               bundle.head_active["w"]))
    int8_bytes = w0_q.size + w1_q.size + hw_q.size \
        + 4 * (w0_s.size + w1_s.size + hw_s.size)
    up = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    f32 = lambda a: up(_host(a).astype(np.float32))
    return {
        "w0_q": up(w0_q), "w0_scale": up(w0_s), "b0": f32(enc["b0"]),
        "w1_q": up(w1_q), "w1_scale": up(w1_s), "b1": f32(enc["b1"]),
        "head_w_q": up(hw_q), "head_w_scale": up(hw_s),
        "head_b": f32(bundle.head_active["b"]),
        "mean": f32(bundle.x_mean),
        "inv_scale": up((1.0 / scale).astype(np.float32)),
        "meta": {"scheme": "int8-symmetric-per-channel",
                 "weight_bytes_fp32": fp32_bytes,
                 "weight_bytes_int8": int(int8_bytes),
                 "compression": round(fp32_bytes / int8_bytes, 2)},
    }


def int8_active_apply(qp: Dict, x: torch.Tensor) -> torch.Tensor:
    """The quantized ``head(g3(x))`` through the int8 matmul kernel:
    standardize -> int8 matmul + fused SELU -> int8 matmul (linear
    latent) -> int8 head matmul.  Three launches on CUDA."""
    x = (x - qp["mean"]) * qp["inv_scale"]
    h = kops.int8_matmul(x, qp["w0_q"], qp["w0_scale"], qp["b0"],
                         act="selu")
    z = kops.int8_matmul(h, qp["w1_q"], qp["w1_scale"], qp["b1"])
    return kops.int8_matmul(z, qp["head_w_q"], qp["head_w_scale"],
                            qp["head_b"])


def dequantized_active_params(qp: Dict) -> Dict:
    """Dequantize a quantized active path once, into the param dict the
    engine's plain active path consumes ({g3: {enc}, head, mean,
    inv_scale}), on the device ``qp`` lives on."""
    dev = qp["b0"].device
    deq = lambda n: torch.from_numpy(
        dequantize_weight(qp[f"{n}_q"], qp[f"{n}_scale"])).to(dev)
    return {
        "g3": {"enc": {"w0": deq("w0"), "b0": qp["b0"],
                       "w1": deq("w1"), "b1": qp["b1"]}},
        "head": {"w": deq("head_w"), "b": qp["head_b"]},
        "mean": qp["mean"], "inv_scale": qp["inv_scale"],
    }


def parity_report(bundle, x, y: Optional[np.ndarray] = None,
                  *, n_classes: Optional[int] = None,
                  device="cuda") -> Dict:
    """Measure the int8-vs-fp32 serving gap on real feature rows: max /
    mean absolute logit delta, prediction flip rate, and (when labels are
    given) the F1/accuracy delta."""
    from repro_torch.core import classifier as clf
    from repro_torch.serve.vfl import VFLServingEngine

    x = np.asarray(x, np.float32)
    fp32 = VFLServingEngine(bundle, device=device)
    q = VFLServingEngine(bundle, quantize="int8", device=device)
    lf = fp32.predict_active(x)
    lq = q.predict_active(x)
    pf = np.argmax(lf, axis=-1)
    pq = np.argmax(lq, axis=-1)
    d = np.abs(lf - lq)
    logit_range = max(float(np.abs(lf).max()), 1e-9)
    report = {
        "scheme": q.quant_meta["scheme"],
        "compression": q.quant_meta["compression"],
        "rows": int(len(x)),
        "max_abs_logit_delta": float(d.max()),
        "mean_abs_logit_delta": float(d.mean()),
        "rel_logit_delta": float(d.max() / logit_range),
        "pred_flip_rate": float(np.mean(pf != pq)),
        "max_logit_delta_bound": MAX_LOGIT_DELTA,
        "rel_logit_delta_bound": MAX_REL_LOGIT_DELTA,
    }
    if y is not None:
        y = np.asarray(y)
        nc = int(n_classes if n_classes is not None else y.max() + 1)
        mf = clf.f1_scores(y, pf, nc)
        mq = clf.f1_scores(y, pq, nc)
        report.update({
            "f1_macro_fp32": mf["f1_macro"], "f1_macro_int8": mq["f1_macro"],
            "f1_macro_delta": abs(mf["f1_macro"] - mq["f1_macro"]),
            "accuracy_fp32": mf["accuracy"], "accuracy_int8": mq["accuracy"],
            "accuracy_delta": abs(mf["accuracy"] - mq["accuracy"]),
            "max_f1_delta_bound": MAX_F1_DELTA,
        })
    return report
