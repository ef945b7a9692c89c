"""xLSTM-350M [arXiv:2405.04517]: 24 blocks, d_model 1024, 4 heads,
vocab 50304, d_ff 0 (no separate FFN; mLSTM blocks carry a 2x inner
up-projection). One sLSTM block closes each group of 8 (xLSTM[7:1])."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        ssm_expand=2, ssm_chunk=256, slstm_period=8)


def smoke() -> ModelConfig:
    return config().with_(n_layers=4, d_model=256, n_heads=2, n_kv_heads=2,
                          vocab_size=512, slstm_period=2, ssm_chunk=32,
                          dtype="float32")
