"""The weights of a cell, drawn from ``--seed`` on the run's device.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  The tree has the layout the program
reads (its stacked ``(L, ...)`` leaves, ``(d_in, d_out)`` matrices);
``layout`` says it leaf by leaf and a CPU test holds it to the program's
own schema.

Every matrix of the model's dtype is a view of one flat buffer drawn by
a single ``torch.randn`` in that dtype on the device and scaled in place
by 1/sqrt(fan_in) (the embedding table keeps unit variance).  The small
fp32 leaves, the norm scales, are drawn U(0.8, 1.2).  Nothing is zero,
so a program that drops a leaf shows it.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _norm(d: int, pre: tuple = ()) -> dict:
    return {"scale": ("norm", pre + (d,))}


def _block(cfg, pre: tuple = ()) -> dict:
    """One decoder block (attention + MLP), stacked over ``pre``."""
    d, H, K, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    mlp = {"w_gate": ("mat", pre + (d, f)), "w_up": ("mat", pre + (d, f)),
           "w_down": ("mat", pre + (f, d))}
    return {"ln1": _norm(d, pre),
            "attn": {"wq": ("mat", pre + (d, H * hd)),
                     "wk": ("mat", pre + (d, K * hd)),
                     "wv": ("mat", pre + (d, K * hd)),
                     "wo": ("mat", pre + (H * hd, d))},
            "ln2": _norm(d, pre), "mlp": mlp}


def layout(cfg) -> dict:
    """The tree of ``(recipe, shape)`` leaves of a dense SwiGLU decoder,
    in the program's layout."""
    if cfg.family != "dense" or cfg.ffn_type != "swiglu":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                         f"{cfg.ffn_type!r} has no layout in the benchmark")
    d, V = cfg.d_model, cfg.vocab_size
    return {"embed": {"tok": ("embed", (V, d)), "out": ("mat", (d, V))},
            "ln_f": _norm(d), "blocks": _block(cfg, (cfg.n_layers,))}


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def draw(cfg, seed: int, device) -> dict:
    """The weights of ``cfg`` from ``seed`` on ``device``."""
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    leaves = list(_leaves(layout(cfg)))
    big = [(p, s) for p, (r, s) in leaves if r in ("mat", "embed")]
    flat = torch.randn(sum(math.prod(s) for _, s in big), generator=gen,
                       dtype=dtype, device=device)
    out: dict = {}
    at = 0
    for path, shape in big:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if not path.endswith("embed.tok"):
            t.mul_(1.0 / math.sqrt(shape[-2]))
        _set(out, path, t)
    for path, (recipe, shape) in leaves:
        if recipe == "norm":
            _set(out, path, 0.8 + 0.4 * torch.rand(
                shape, generator=gen, dtype=torch.float32, device=device))
    return out
