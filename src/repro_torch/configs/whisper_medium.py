"""whisper-medium [audio]: encoder-decoder, conv frontend stubbed.

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. [arXiv:2212.04356]

Per the assignment the mel-spectrogram + conv feature extractor is a STUB:
``input_specs`` provides precomputed frame embeddings (B, 1500, d_model) as
the encoder input; we implement the transformer encoder and the
cross-attending decoder. 24L is interpreted as 24 encoder + 24 decoder
layers (the whisper-medium card).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=24,            # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    norm_type="layernorm",
    mlp_type="gelu",
    learned_pos_emb=True,
    embedding_inputs=True,    # encoder consumes stubbed frame embeddings
    tie_embeddings=True,
)
