"""The reference forward of a cell's model: plain PyTorch in fp32 with TF32
off, one sequence at a time, layer by layer, on the device the weights
live on.  It reads the benchmark's weights (``harness/weights.py``'s
layout) and the configuration file's sizes; it imports nothing of the
program or of JAX, and works out again everything the program derives
(the KV cache of a served sequence is this full forward over the prompt
and the tokens served so far).

- dense: embedding, n_layers pre-norm decoder blocks (GQA attention with
  RoPE, SwiGLU), final RMSNorm, the unembedding matrix.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from bench.reference.layers import F32, decoder_block, linear, rmsnorm


@dataclass(frozen=True)
class Sizes:
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    ffn_type: str = "swiglu"
    rope_theta: float = 1e6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def sizes(fields: dict) -> Sizes:
    """``Sizes`` from a configuration file's model fields."""
    keys = Sizes.__dataclass_fields__
    return Sizes(**{k: v for k, v in fields.items() if k in keys})


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def _pick(tree, i: int):
    """Layer ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def hidden(w: dict, m: Sizes, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The final hidden states (S, d) of one sequence ``tokens`` (S,)."""
    if m.family != "dense":
        raise ValueError(f"no reference for family {m.family!r}")
    x = w["embed"]["tok"][tokens.long()].to(F32)
    for i in range(m.n_layers):
        x = decoder_block(_pick(w["blocks"], i), m, x, precision)
    return x


@torch.no_grad()
def logits_at(w: dict, m: Sizes, tokens: torch.Tensor, rows,
              precision: str = "fp32") -> torch.Tensor:
    """The logits (len(rows), vocab) at positions ``rows`` of one sequence
    ``tokens`` (S,): row r predicts the token after position r."""
    with exact_fp32():
        x = hidden(w, m, tokens, precision)[rows]
        x = rmsnorm(x, w["ln_f"]["scale"])
        return linear(x, w["embed"]["out"], precision)
