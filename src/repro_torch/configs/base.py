"""Model configuration: the fields of the reference's ``ModelConfig``
(repro/configs/base.py) that the paper's MLP reads."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # only "mlp" is ported
    source: str = ""
    num_layers: int = 2          # hidden layers
    d_model: int = 256           # hidden width
    vocab_size: int = 1024       # number of classes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
