"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: MoE decoder. 48L, d_model 2048,
32 heads (kv 4, head_dim 128), 128 experts top-8, per-expert d_ff 768,
vocab 151936."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=768, vocab_size=151936,
        head_dim=128, ffn_type="swiglu", rope_theta=1e6,
        n_experts=128, experts_per_token=8)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=128, vocab_size=512,
                          n_experts=4, experts_per_token=2, dtype="float32")
