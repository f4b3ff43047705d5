"""The paper's own experimental scale (repro/configs/dwfl_paper.py): a
3072 -> 256 -> 256 -> 10 MLP classifier on CIFAR-shaped synthetic data.
The transformer-shaped fields are unused by the MLP."""
from repro_torch.configs.base import ModelConfig

DWFL_PAPER = ModelConfig(
    name="dwfl-paper",
    family="mlp",
    source="this paper, Sec. V (CIFAR-10 -> synthetic substitution)",
    num_layers=2,          # hidden layers
    d_model=256,           # hidden width
    num_heads=1,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=10,         # number of classes
)

INPUT_DIM = 3072  # 32*32*3, CIFAR-shaped
