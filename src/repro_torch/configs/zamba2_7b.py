"""zamba2-7b [hybrid]: Mamba2 backbone with one shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242]

``LONG_CONTEXT_VARIANT`` is the reference's sliding-window variant (window
4096) of the shared attention block, used only for the long_500k shape:
the Mamba2 backbone keeps O(1) state, the attention must not build a
524k dense KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    shared_attn_every=6,   # one shared attention(+MLP) block after every 6 mamba layers
    mlp_type="swiglu",
    norm_type="rmsnorm",
)

LONG_CONTEXT_VARIANT = CONFIG.replace(name="zamba2-7b-sw4096", sliding_window=4096)
