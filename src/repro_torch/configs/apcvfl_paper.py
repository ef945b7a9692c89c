"""The paper's tabular-protocol hyperparameters (Appendix B) and its scaled
student-encoder backbone: a copy of ``repro.configs.apcvfl_paper``.  Every
``run_*`` entry point in ``repro_torch.core`` defaults its kwargs from
``TABULAR``; ``config()`` names the dense encoder that plays g3 under the
``apcvfl_distill`` objective at scale."""
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class TabularHparams:
    """Paper Appendix B defaults for the tabular APC-VFL stack."""
    batch_size: int = 128
    max_epochs: int = 200       # <=200 epochs ...
    patience: int = 10          # ... with early stopping, patience 10
    lr: float = 1e-3            # Adam, Kingma & Ba defaults
    lam: float = 0.01           # Eq. 5 distillation weight
    kind: str = "mse"           # distillation distance
    test_size: int = 500        # held-out rows in the SplitNN comparison


TABULAR = TabularHparams()


def config() -> ModelConfig:
    # the student-encoder backbone of the apcvfl_distill objective at scale:
    # a small dense GQA encoder whose pooled hidden state is z = g3(x)
    return ModelConfig(
        name="apcvfl-paper", family="dense", n_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=4096, vocab_size=32768,
        head_dim=64, ffn_type="swiglu")


def smoke() -> ModelConfig:
    return config().with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, d_ff=512, vocab_size=512,
                          dtype="float32")
