"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + ONE shared
attention+MLP block applied every 6 mamba layers. 54L, d_model 2560,
shared block: 32 MHA heads (kv 32), d_ff 10240; vocab 32000; ssm_state 64."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, ffn_type="gelu", rope_theta=1e4,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        attn_period=6)


def smoke() -> ModelConfig:
    return config().with_(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                          head_dim=64, d_ff=512, vocab_size=512,
                          ssm_head_dim=32, ssm_chunk=32, attn_period=2,
                          dtype="float32")
