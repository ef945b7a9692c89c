"""One-token decode attention of a decode step: one launch a layer.
Operations: 4 * hd a (query head, valid slot) pair.  Bytes: the K and V
rows of the valid slots only, q read and o written once, in the model's
dtype, and the slot positions (int32) once."""
NAMES = ("decode_kernel",)
DTYPE = "bfloat16"


def work(cfg, call: dict) -> tuple:
    if call["mode"] != "decode":
        return 0.0, 0.0
    B, ctx = call["B"], call["ctx"]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    esize = 4 if cfg.dtype == "float32" else 2
    flops = 4.0 * B * H * hd * ctx
    nbytes = esize * (2.0 * B * ctx * K * hd + 2.0 * B * H * hd) \
        + 4.0 * call["slots"]
    return cfg.n_layers * flops, cfg.n_layers * nbytes
