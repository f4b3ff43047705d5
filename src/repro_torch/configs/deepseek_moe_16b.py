"""deepseek-moe-16b [moe]: 2 shared + 64 routed experts, top-6, fine-grained.

28L d_model=2048 16H (kv=16) moe_d_ff=1408 vocab=102400, MoE 64e top-6.
First layer is a dense FFN (deepseek-moe card). [arXiv:2401.06066]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,           # dense-FFN hidden dim for the first dense layer
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    mlp_type="swiglu",
)
