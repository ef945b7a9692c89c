"""InternLM2-20B [arXiv:2403.17297]: dense GQA decoder.
48L, d_model 6144, 48 heads (kv 8), d_ff 16384, vocab 92544, swiglu."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92544,
        head_dim=128, ffn_type="swiglu", rope_theta=1e6)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=512,
                          dtype="float32")
