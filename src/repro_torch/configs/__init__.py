from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.dwfl_paper import DWFL_PAPER, INPUT_DIM  # noqa: F401
