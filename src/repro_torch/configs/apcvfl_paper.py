"""The paper's tabular-protocol hyperparameters (Appendix B): a copy of
``TabularHparams`` / ``TABULAR`` in ``repro.configs.apcvfl_paper``.  Every
``run_*`` entry point in ``repro_torch.core`` defaults its kwargs from
``TABULAR``."""
from dataclasses import dataclass


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
