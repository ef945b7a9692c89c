"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision]: dense GQA
decoder with gated cross-attention image layers. 40L, d_model 4096,
32 heads (kv 8), d_ff 14336, vocab 128256; one cross-attn block closes each
group of 5 layers (8 cross layers). The ViT vision encoder + projector is a
STUB: ``input_specs`` provides projected patch embeddings
(B, n_image_tokens, d_model)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
        head_dim=128, ffn_type="swiglu", rope_theta=5e5,
        cross_attn_period=5, n_image_tokens=1600)


def smoke() -> ModelConfig:
    return config().with_(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=512,
                          cross_attn_period=2, n_image_tokens=16,
                          dtype="float32")
