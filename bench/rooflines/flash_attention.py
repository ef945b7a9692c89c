"""Causal flash attention of a prefill call: one launch a layer.
Operations: 4 * hd a (query, key) pair below the diagonal (QK^T and PV,
2 a multiply-add).  Bytes: q, k, v read once and o written once, in the
model's dtype."""
NAMES = ("flash_kernel",)
DTYPE = "bfloat16"


def work(cfg, call: dict) -> tuple:
    if call["mode"] != "prefill":
        return 0.0, 0.0
    B, S = call["B"], call["S"]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    esize = 4 if cfg.dtype == "float32" else 2
    flops = 4.0 * B * H * hd * (S * (S + 1) / 2)
    nbytes = esize * (2.0 * B * S * H * hd + 2.0 * B * S * K * hd)
    return cfg.n_layers * flops, cfg.n_layers * nbytes
