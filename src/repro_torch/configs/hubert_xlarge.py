"""HuBERT X-Large [arXiv:2106.07447]: encoder-only audio transformer
(wav2vec2 backbone). 48L, d_model 1280, 16 MHA heads, d_ff 5120, 504-unit
target vocabulary. The conv waveform frontend is a STUB, as in the
reference: the model takes precomputed frame embeddings (B, S, d_model)
as ``inputs["frames"]``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
        head_dim=80, ffn_type="gelu", norm="layernorm", causal=False,
        rope_theta=1e4)


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                          head_dim=64, d_ff=512, dtype="float32")
