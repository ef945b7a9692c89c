"""Kimi-K2 [arXiv:2501.kimi2]: trillion-parameter MoE (paper-table entry).
61L, d_model 7168, 64 heads (GQA kv 8 per assignment), 384 experts top-8,
per-expert d_ff 2048, vocab 163840."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=2048, vocab_size=163840,
        head_dim=128, ffn_type="swiglu", rope_theta=5e6,
        n_experts=384, experts_per_token=8)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=128, vocab_size=512,
                          n_experts=4, experts_per_token=2, dtype="float32")
