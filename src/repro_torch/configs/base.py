"""Model configuration, a copy of the reference's ``repro/configs/base.py``
(data only: the port never imports the reference). ``ModelConfig``
carries the fields of the reference's that the port reads, with the
reference's defaults, ``resolved_head_dim``, ``is_subquadratic`` and
``reduced()``, so a configuration means the same model in both packages,
and the reference's four input shapes (``ShapeConfig``, ``SHAPES``), which
the dry run (``launch.specs``, ``launch.dryrun``) reads.
The reference's ``remat``, ``tp_hints`` and ``remat_policy`` are JAX
knobs (activation checkpointing over ``lax.scan``, sharding hints) that
nothing in the port reads, and stay out."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str  # mlp | dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    # -- trunk dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None  # default d_model // num_heads (gemma: 256)

    # -- norm / mlp ---------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)

    # -- attention ----------------------------------------------------------
    rope_theta: float = 10000.0
    use_mrope: bool = False  # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # (t, h, w) per-half-dim split
    qkv_bias: bool = False  # qwen2 / glm4
    sliding_window: Optional[int] = None
    learned_pos_emb: bool = False  # whisper decoder/encoder

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (fine-grained experts)
    first_dense_layers: int = 0  # deepseek-moe: layer 0 is a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # -- SSM (mamba2 / xlstm) ---------------------------------------------------------
    ssm_state: int = 0  # N, state dim per head
    ssm_heads: int = 0  # number of SSM heads (defaults derived)
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # chunk length for the SSD scan
    slstm_every: int = 0  # xlstm: every k-th block is sLSTM (0 = none)

    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0  # apply the shared attention block every k SSM layers

    # -- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30 s of audio -> 1500 frames

    # -- modality stub (vlm / audio): inputs are precomputed embeddings -------
    embedding_inputs: bool = False

    # -- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this config serve a 500k-token context (O(S) state, no dense KV)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (2 layers, d<=512)."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
        )
        group = max(1, self.num_heads // max(1, self.num_kv_heads))
        small["num_kv_heads"] = max(1, min(self.num_kv_heads, small["num_heads"],
                                           max(1, small["num_heads"] // group)))
        if self.num_experts:
            small.update(num_experts=4,
                         num_experts_per_tok=min(2, self.num_experts_per_tok),
                         num_shared_experts=min(1, self.num_shared_experts),
                         moe_d_ff=min(self.moe_d_ff, 128))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_heads=0, ssm_chunk=32)
        if self.slstm_every:
            small.update(slstm_every=2)
        if self.shared_attn_every:
            small.update(shared_attn_every=2)
        if self.is_encoder_decoder:
            small.update(num_encoder_layers=2, encoder_seq_len=64)
        if self.sliding_window:
            small.update(sliding_window=32)
        small.update(kw)
        return self.replace(**small)



@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input workloads."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}
