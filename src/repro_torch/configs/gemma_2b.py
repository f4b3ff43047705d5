"""gemma-2b [dense]: GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000. [arXiv:2403.08295]

``LONG_CONTEXT_VARIANT`` is the reference's beyond-config sliding-window
variant (window 4096), used only for the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

LONG_CONTEXT_VARIANT = CONFIG.replace(name="gemma-2b-sw4096", sliding_window=4096)
