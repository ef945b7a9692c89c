"""Config dataclasses: model architectures and benchmark input shapes (a
copy of ``repro.configs.base``).

Every architecture module in ``repro_torch.configs`` exports ``config()``
(the full-size config, source cited) and ``smoke()`` (a reduced
same-family variant for CPU tests: <= 2 layers, d_model <= 512).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    ffn_type: str = "swiglu"    # swiglu | squared_relu | gelu
    causal: bool = True
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2) / xLSTM ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    slstm_period: int = 0       # xlstm: one sLSTM block closes each group of this size
    # --- hybrid (zamba2) ---
    attn_period: int = 0        # shared attention block after every N ssm layers
    # --- vlm ---
    cross_attn_period: int = 0  # one cross-attn block closes each group of this size
    n_image_tokens: int = 0
    # --- attention variants ---
    sliding_window: int = 0     # 0 = full attention (training/prefill)
    long_context_window: int = 8192   # window for long_500k decode mode
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: bool = False
    # full-sequence, prefill and decode attention through the port's
    # flash-attention and decode-attention kernels (models/attention.py)
    use_flash_kernel: bool = False
    # the reference's sharding knobs: kept so configs compare field for
    # field; without a mesh they change nothing here
    fsdp_params: bool = True
    replicate_kv: bool = False
    attn_chunk: int = 0         # >0: chunked online-softmax attention
    seq_parallel: bool = False
    mesh_axes: tuple = ()
    ssd_bf16: bool = False      # bf16 intra-chunk SSD matmuls (states stay fp32)
    softmax_bf16: bool = False  # bf16 attention scores/probs

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Parameter count from the init schema's shapes (no allocation)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
