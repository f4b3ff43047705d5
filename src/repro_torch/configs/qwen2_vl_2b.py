"""qwen2-vl-2b [vlm]: decoder LM backbone with M-RoPE; vision tower stubbed.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. [arXiv:2409.12191]

As in the reference, the ViT/projector frontend is a stub: the inputs are
precomputed patch/text embeddings [B, S, d_model], and the backbone is the
language decoder that consumes them (M-RoPE over (t, h, w) position ids).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    use_mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    mlp_type="swiglu",
    embedding_inputs=True,
    tie_embeddings=True,
)
