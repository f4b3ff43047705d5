"""xlstm-1.3b [ssm]: alternating mLSTM / sLSTM blocks (xLSTM[7:1]).

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304. [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up/down projections (pre-up-projection
mLSTM with expansion 2, gated); there is no separate FFN. Every 8th block is
an sLSTM block (scalar memory, true recurrence), the rest are mLSTM (matrix
memory, chunkwise-parallel).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_state=0,        # mLSTM state dim == head_dim (matrix memory), not a separate N
    ssm_expand=2,
    # chunk=128 balances the two O(S)-traffic terms of the chunked mLSTM:
    # intra-chunk quadratic bytes scale with S*q, inter-chunk (C,n,m) state
    # bytes with S/q * dk*dv (fat 512x1024 heads!). Measured (§Perf xlstm
    # iteration 5): q=64 cuts intra but balloons state traffic (+33% memory
    # term) — q=128 is the sweet spot.
    ssm_chunk=128,
    slstm_every=8,      # xLSTM[7:1]
    norm_type="layernorm",
)
