"""The model flops of a call, frozen here from the configuration's shapes:
the matmul and attention operations the forward pass needs (2 a
multiply-add), whatever the program computes.  ``mfu.*`` divide them by
the bf16 peak times the wall.

- Every projection of every token (q, k, v, o; the SwiGLU MLP's three).
- Attention over the valid (query, key) pairs: the causal lower triangle
  in a prefill, the ``ctx`` cached positions in a decode step.
- The unembedding of the rows that are served: each prompt's last
  position in a prefill, each session's token in a decode step.
"""
from __future__ import annotations


def _block_linear(cfg) -> float:
    d, H, K, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    attn = 2.0 * (d * H * hd + 2 * d * K * hd + H * hd * d)
    mlp = 2.0 * 3 * d * f
    return attn + mlp


def prefill_flops(cfg, B: int, S: int) -> float:
    pairs = S * (S + 1) / 2
    per_seq = cfg.n_layers * (S * _block_linear(cfg)
                              + 4.0 * cfg.n_heads * cfg.hd * pairs)
    return B * (per_seq + 2.0 * cfg.d_model * cfg.vocab_size)


def decode_flops(cfg, B: int, ctx: int) -> float:
    per_token = cfg.n_layers * (_block_linear(cfg)
                                + 4.0 * cfg.n_heads * cfg.hd * ctx)
    return B * (per_token + 2.0 * cfg.d_model * cfg.vocab_size)


def call_flops(cfg, call: dict) -> float:
    if call["mode"] == "prefill":
        return prefill_flops(cfg, call["B"], call["S"])
    return decode_flops(cfg, call["B"], call["ctx"])
