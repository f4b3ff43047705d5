"""Mamba2 (SSD, state space dual) blocks, chunkwise-parallel (the
reference's ``repro.models.ssm``).

Per-head scalar decay a_t = exp(dt_t A_h) (A_h < 0), rank-1 state updates
h_t = a_t h_{t-1} + dt_t B_t x_tᵀ with state h in R^{P x N}, and readout
y_t = C_t . h_t + D_h x_t. Train and prefill run the chunked algorithm:
``ssd_chunked`` (intra-chunk quadratic, exact causal, plus the inter-chunk
state recurrence as a loop over the chunks), or with ``use_pallas=True``
``kernels/ssd_scan/ops.py::ssd_scan`` (the CUDA kernel on the card, its
plain twin on the CPU). Cumulative sums take the reference's float32
order (``cumsum_f32``). Decode is the O(1) recurrent step, plain torch,
and writes the new conv history and state into the cache it is given, in
place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ssd_scan import cumsum_f32, inter_chunk
from repro_torch.models import layers as L

HEAD_DIM = 64  # Mamba2 default P


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = HEAD_DIM
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def ssm_block_init(generator: torch.Generator, cfg: ModelConfig, dtype, device,
                   stack=()):
    """One block's parameters (the reference's keys, shapes and scales);
    ``stack`` prepends layer axes."""
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N  # conv over [x ; B ; C]
    conv_w = torch.randn(stack + (cfg.ssm_conv_width, conv_dim),
                         generator=generator, device=device) * 0.2
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "norm": L.norm_init(cfg, dtype, device, stack),
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "w_in": L.dense_init(generator, cfg.d_model, 2 * d_inner + 2 * N + H,
                             dtype, device, stack),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(stack + (conv_dim,), dtype=dtype, device=device),
        "A_log": A_log.expand(stack + (H,)).contiguous(),
        "dt_bias": torch.zeros(stack + (H,), dtype=torch.float32, device=device),
        "D": torch.ones(stack + (H,), dtype=dtype, device=device),
        "gate_norm": {"scale": torch.ones(stack + (d_inner,), dtype=dtype,
                                          device=device)},
        "w_out": L.dense_init(generator, d_inner, cfg.d_model, dtype, device,
                              stack),
    }


def _split_in(proj: torch.Tensor, cfg: ModelConfig):
    d_inner, H, P, N = dims(cfg)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + d_inner + 2 * N]
    dt = proj[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor):
    """Depthwise causal conv1d over time. xBC: [B,S,D]; conv_w: [W,D]."""
    W = conv_w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + S] * conv_w[i]
    return F.silu(out + conv_b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] log-decay per step -> cumulative decay matrix [..., Q, Q]:
    out[i, j] = sum_{k=j+1..i} a_k for j <= i, else -inf."""
    Q = a.shape[-1]
    cs = cumsum_f32(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan (the reference's oracle).

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative); Bm, Cm:
    [B,S,N] (one group, broadcast over the heads). Returns (y [B,S,H,P]
    float32, final_state [B,H,P,N] float32). S must be a multiple of chunk.
    """
    Bb, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    q = chunk

    xc = xh.float().reshape(Bb, nc, q, H, P)
    dtc = dt.float().reshape(Bb, nc, q, H)
    Bc = Bm.float().reshape(Bb, nc, q, N)
    Cc = Cm.float().reshape(Bb, nc, q, N)

    dA = dtc * A.float()                        # [B,nc,q,H] log decay per step
    dA_cs = cumsum_f32(dA, dim=2)               # within-chunk cumulative

    # ---- intra-chunk (quadratic, exact causal)
    Lmat = torch.exp(_segsum(dA.movedim(-1, -2)))           # [B,nc,H,q,q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)        # [B,nc,q,q]
    gated = scores[:, :, None] * Lmat                        # [B,nc,H,q,q]
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gated, xdt)  # [B,nc,q,H,P]

    # ---- chunk-local final states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # [B,nc,q,H]
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, dtc * decay_to_end, xc)

    # ---- inter-chunk recurrence and contribution to the outputs
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # [B,nc,H]
    y_off, h = inter_chunk(states, chunk_decay, dA_cs, Cc, initial_state)
    return (y_diag + y_off).reshape(Bb, S, H, P), h


def ssd_decode_step(x1, dt1, A, B1, C1, state):
    """One recurrent step. x1: [B,H,P]; dt1: [B,H]; B1, C1: [B,N]; state
    [B,H,P,N]. Returns (y [B,H,P], new state). Each product takes its
    operands in their promoted dtype, as jnp.einsum does (bfloat16 B1, C1
    against the float32 state)."""
    dec = torch.exp(dt1 * A[None, :])                                  # [B,H]
    xdt = x1 * dt1[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt,
                       B1.to(torch.promote_types(xdt.dtype, B1.dtype)))
    state = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state,
                     C1.to(torch.promote_types(state.dtype, C1.dtype)))
    return y, state


def ssm_block_apply(params, x: torch.Tensor, cfg: ModelConfig, mode: str,
                    cache=None, use_pallas: bool = False):
    """x: [B,S,d]. Returns (y, cache). Cache: {'conv': [B,W-1,D], 'state':
    [B,H,P,N]}: prefill returns new ones, decode writes into the cache it
    is given and returns it."""
    d_inner, H, P, N = dims(cfg)
    res = x
    xn = L.norm_apply(params["norm"], x, cfg)
    proj = xn @ params["w_in"]
    z, xBC, dt_raw = _split_in(proj, cfg)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    new_cache = None
    if mode == "decode":
        if cache is None or x.shape[1] != 1:
            raise ValueError("decode takes one token and a cache")
        conv_hist = torch.cat([cache["conv"], xBC], dim=1)            # [B,W,D]
        conv_out = (conv_hist * params["conv_w"][None]).sum(dim=1) + params["conv_b"]
        xBC1 = F.silu(conv_out)                                        # [B,D]
        xh = xBC1[..., :d_inner].reshape(-1, H, P)
        B1 = xBC1[..., d_inner:d_inner + N]
        C1 = xBC1[..., d_inner + N:]
        y, state = ssd_decode_step(xh, dt[:, 0], A, B1, C1, cache["state"])
        y = y.reshape(-1, 1, d_inner)
        cache["conv"].copy_(conv_hist[:, 1:])
        cache["state"].copy_(state)
        new_cache = cache
    else:
        xBCc = _causal_conv(xBC, params["conv_w"], params["conv_b"])
        Bsz, S = x.shape[0], x.shape[1]
        xh = xBCc[..., :d_inner].reshape(Bsz, S, H, P)
        Bm = xBCc[..., d_inner:d_inner + N]
        Cm = xBCc[..., d_inner + N:]
        if use_pallas:
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y, state = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        else:
            y, state = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S))
        y = y.reshape(Bsz, S, d_inner)
        if mode == "prefill":
            W = cfg.ssm_conv_width
            # a copy: a view would keep the whole [B, S, 2 d_inner + 2N + H]
            # projection of every layer alive until the prefill ends
            new_cache = {"conv": xBC[:, -(W - 1):].clone(), "state": state}

    y = y.to(x.dtype) + (xh.reshape(y.shape).to(x.dtype)
                         * params["D"].repeat_interleave(P))  # skip connection
    # gated output norm (mamba2: RMSNorm(y * silu(z)))
    g = y * F.silu(z)
    gf = g.float()
    g = (gf * torch.rsqrt((gf * gf).mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
    g = g * params["gate_norm"]["scale"]
    return res + g @ params["w_out"], new_cache
