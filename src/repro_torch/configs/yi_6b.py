"""Yi-6B [arXiv:2403.04652]: llama-architecture dense GQA decoder.
32L, d_model 4096, 32 heads (kv 4), d_ff 11008, vocab 64000."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
        head_dim=128, ffn_type="swiglu", rope_theta=5e6)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=512,
                          dtype="float32")
