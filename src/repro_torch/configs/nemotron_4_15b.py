"""Nemotron-4-15B [arXiv:2402.16819]: dense GQA decoder with squared-ReLU
MLP and 256k vocabulary. 32L, d_model 6144, 48 heads (kv 8), d_ff 24576."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab_size=256000,
        head_dim=128, ffn_type="squared_relu", norm="layernorm",
        rope_theta=1e4)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=512,
                          dtype="float32")
