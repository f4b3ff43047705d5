"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a true recurrence), the reference's
``repro.models.xlstm``.

mLSTM cell (per head, exponential gating, stabilized):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)                (log-space stabilizer)
    C_t = exp(f̃_t + m_{t-1} - m_t) C_{t-1} + exp(ĩ_t - m_t) k_t v_tᵀ
    n_t = exp(f̃_t + m_{t-1} - m_t) n_{t-1} + exp(ĩ_t - m_t) k_t
    h_t = (C_tᵀ q_t) / max(|n_tᵀ q_t|, exp(-m_t))
with f̃ = logsigmoid(f_raw), ĩ = i_raw. Chunkwise: an intra-chunk decay
matrix plus the inter-chunk (C, n, m) recurrence, a Python loop over the
chunks. The xLSTM block is pre-up-projection (expansion 2): the mLSTM
runs at d_inner = 2 d_model with a silu-gated residual branch; qk dim =
d_inner / 2. sLSTM blocks keep scalar memory per channel with recurrent
block-diagonal weights, a Python loop over the sequence, and a small gated
FFN after the cell.

The stabilizers start where the reference's do: the chunked mLSTM's m at
-inf, the decode cache's and the sLSTM's at -1e30, the combined m clamped
at -1e30. Train and prefill need S to be a multiple of the chunk,
min(ssm_chunk, S), as in the reference. Decode writes the new state into
the cache it is given, in place, and returns that cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

QK_FACTOR = 2  # qk dim = d_inner // QK_FACTOR


def mlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    dv = d_inner // H               # value head dim
    dk = d_inner // QK_FACTOR // H  # query/key head dim
    return d_inner, H, dk, dv


def _rms(h: torch.Tensor, dtype) -> torch.Tensor:
    hf = h.float()
    return (hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + 1e-6)).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    d_inner, H, dk, dv = mlstm_dims(cfg)
    if_bias = torch.cat([torch.zeros(H, device=device),
                         torch.linspace(3.0, 6.0, H, device=device)])
    return {
        "norm": L.norm_init(cfg, dtype, device, stack),
        "w_up": L.dense_init(generator, cfg.d_model, 2 * d_inner, dtype, device,
                             stack),                     # [branch, gate]
        "w_q": L.dense_init(generator, d_inner, H * dk, dtype, device, stack),
        "w_k": L.dense_init(generator, d_inner, H * dk, dtype, device, stack),
        "w_v": L.dense_init(generator, d_inner, H * dv, dtype, device, stack),
        "w_if": L.dense_init(generator, d_inner, 2 * H, dtype, device, stack),
        "if_bias": if_bias.expand(stack + (2 * H,)).contiguous(),
        "out_norm": {"scale": torch.ones(stack + (d_inner,), dtype=dtype,
                                         device=device)},
        "w_down": L.dense_init(generator, d_inner, cfg.d_model, dtype, device,
                               stack),
    }


def _mm(t: torch.Tensor, dtype) -> torch.Tensor:
    """An operand rounded to ``dtype`` and multiplied in float32: the
    reference's ``matmul_dtype`` operands with ``preferred_element_type``
    float32."""
    return t.to(dtype).float()


def _mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int, initial=None,
                   matmul_dtype=torch.float32):
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; i_raw, f_raw: [B, S, H]
    (pre-activation). Returns (h [B, S, H, dv], final (C [B, H, dk, dv],
    n [B, H, dk], m [B, H]))."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"the chunked mLSTM needs S to be a multiple of its "
                         f"chunk {chunk}, got S={S}")
    qn = chunk

    lf = F.logsigmoid(f_raw.float()).reshape(B, nc, qn, H)
    li = i_raw.float().reshape(B, nc, qn, H)
    qc = q.reshape(B, nc, qn, H, dk)
    kc = k.reshape(B, nc, qn, H, dk)
    vc = v.reshape(B, nc, qn, H, dv)

    lf_cs = torch.cumsum(lf, dim=2)                  # cumulative log-forget in chunk
    lf_total = lf_cs[:, :, -1, :]                    # [B, nc, H]
    # log weight of key j surviving to chunk end: sum_{j+1..end} lf + li_j
    b_end = lf_total[:, :, None, :] - lf_cs + li     # [B, nc, q, H]
    m_local = b_end.amax(dim=2)                      # [B, nc, H]

    if initial is None:
        C = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), -math.inf, dtype=torch.float32, device=q.device)
    else:
        C, n, m = initial

    # ---- inter-chunk recurrence on (C, n, m) ------------------------------
    Cp, np_, mp = [], [], []
    for c in range(nc):
        Cp.append(C)
        np_.append(n)
        mp.append(m)
        kj, vj = kc[:, c].float(), vc[:, c].float()
        m_new = torch.maximum(lf_total[:, c] + m, m_local[:, c])
        decay = torch.exp(lf_total[:, c] + m - m_new)           # [B, H]
        w = torch.exp(b_end[:, c] - m_new[:, None, :])          # [B, q, H]
        kw = kj * w[..., None]
        C = C * decay[..., None, None] + torch.einsum("bqhk,bqhv->bhkv", kw, vj)
        n = n * decay[..., None] + kw.sum(dim=1)
        m = m_new
    Cp = torch.stack(Cp, dim=1)     # [B, nc, H, dk, dv] state entering each chunk
    np_ = torch.stack(np_, dim=1)   # [B, nc, H, dk]
    mp = torch.stack(mp, dim=1)     # [B, nc, H]

    # ---- intra + inter contributions per step ------------------------------
    # intra_b[t, j] = sum_{j+1..t} lf + li_j, valid for j <= t
    intra_b = (lf_cs[:, :, :, None, :] - lf_cs[:, :, None, :, :]
               + li[:, :, None, :, :])                          # [B, nc, t, j, H]
    qt = torch.arange(qn, device=q.device)
    causal = (qt[:, None] >= qt[None, :])[None, None, :, :, None]
    intra_b = torch.where(causal, intra_b, -math.inf)
    m_intra = intra_b.amax(dim=3)                               # [B, nc, t, H]
    m_comb = torch.maximum(lf_cs + mp[:, :, None, :], m_intra)
    m_comb = torch.clamp(m_comb, min=-1e30)                     # no -inf - -inf

    w_intra = torch.exp(intra_b - m_comb[:, :, :, None, :])
    scores = torch.einsum("bcthk,bcjhk->bctjh", _mm(qc, matmul_dtype),
                          _mm(kc, matmul_dtype))
    P = scores * w_intra                                        # [B, nc, t, j, H]
    qn_intra = P.sum(dim=3)
    h_intra = torch.einsum("bctjh,bcjhv->bcthv", _mm(P, matmul_dtype),
                           _mm(vc, matmul_dtype))
    w_inter = torch.exp(lf_cs + mp[:, :, None, :] - m_comb)     # [B, nc, t, H]
    qf = qc.float()
    h_inter = torch.einsum("bcthk,bchkv->bcthv", qf, Cp) * w_inter[..., None]
    qn_inter = torch.einsum("bcthk,bchk->bcth", qf, np_) * w_inter

    denom = torch.maximum((qn_intra + qn_inter).abs(), torch.exp(-m_comb))
    h = ((h_intra + h_inter) / denom[..., None]).reshape(B, S, H, dv)
    return h.to(v.dtype), (C, n, m)


def mlstm_decode_step(q1, k1, v1, i1, f1, state):
    """One step. q1, k1: [B, H, dk]; v1: [B, H, dv]; i1, f1: [B, H];
    state (C, n, m). Returns (h [B, H, dv], (C, n, m))."""
    C, n, m = state
    lf = F.logsigmoid(f1.float())
    li = i1.float()
    m_new = torch.maximum(lf + m, li)
    decay = torch.exp(lf + m - m_new)
    w = torch.exp(li - m_new)
    kf = k1.float()
    C = C * decay[..., None, None] + torch.einsum(
        "bhk,bhv->bhkv", kf * w[..., None], v1.float())
    n = n * decay[..., None] + kf * w[..., None]
    qf = q1.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.einsum("bhk,bhk->bh", qf, n)
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    return (num / den[..., None]).to(v1.dtype), (C, n, m_new)


def mlstm_block_apply(params, x, cfg: ModelConfig, mode: str, cache=None):
    """Returns (y, cache): prefill the final {"C", "n", "m"}, decode the
    cache it was given, updated in place; train None."""
    d_inner, H, dk, dv = mlstm_dims(cfg)
    xn = L.norm_apply(params["norm"], x, cfg)
    up = xn @ params["w_up"]
    branch, gate = up[..., :d_inner], up[..., d_inner:]
    B, S = x.shape[0], x.shape[1]
    q = (branch @ params["w_q"]).reshape(B, S, H, dk) / math.sqrt(dk)
    k = (branch @ params["w_k"]).reshape(B, S, H, dk)
    v = (branch @ params["w_v"]).reshape(B, S, H, dv)
    if_logits = (branch @ params["w_if"]).float() + params["if_bias"]
    i_raw, f_raw = if_logits[..., :H], if_logits[..., H:]

    new_cache = None
    if mode == "decode":
        h1, (C, n, m) = mlstm_decode_step(
            q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0],
            (cache["C"], cache["n"], cache["m"]))
        h = h1[:, None]
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        cache["m"].copy_(m)
        new_cache = cache
    else:
        h, (C, n, m) = _mlstm_chunked(q, k, v, i_raw, f_raw,
                                      min(cfg.ssm_chunk, S),
                                      matmul_dtype=L._dtype(cfg.compute_dtype))
        if mode == "prefill":
            new_cache = {"C": C, "n": n, "m": m}

    h = _rms(h.reshape(B, S, d_inner), x.dtype) * params["out_norm"]["scale"]
    h = h * F.silu(gate)
    return x + h @ params["w_down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    r = torch.randn(stack + (H, P, 4 * P), generator=generator, device=device)
    return {
        "norm": L.norm_init(cfg, dtype, device, stack),
        "w_zifo": L.dense_init(generator, d, 4 * d, dtype, device, stack),
        # recurrent weights, block-diagonal per head: [H, P, 4P]
        "r_zifo": (r / math.sqrt(P)).to(dtype),
        "b_zifo": torch.zeros(stack + (4 * d,), dtype=torch.float32,
                              device=device),
        "out_norm": {"scale": torch.ones(stack + (d,), dtype=dtype,
                                         device=device)},
        "w_up": L.dense_init(generator, d, 2 * d, dtype, device, stack),
        "w_down": L.dense_init(generator, d, cfg.d_model, dtype, device, stack),
    }


def _slstm_cell(carry, zifo, H: int, P: int):
    """carry: (c, n, m, h), c/n/h [B, H, P], m [B, H]; zifo: [B, 4 H P],
    the input and recurrent contributions summed."""
    c, n, m, h = carry
    zifo = zifo.reshape(c.shape[0], H, 4, P)
    z = torch.tanh(zifo[:, :, 0])
    i_raw = zifo[:, :, 1].mean(-1)   # per-head scalar gates
    f_raw = zifo[:, :, 2].mean(-1)
    o = torch.sigmoid(zifo[:, :, 3])
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    fs = torch.exp(lf + m - m_new)[..., None]
    is_ = torch.exp(i_raw - m_new)[..., None]
    c_new = fs * c + is_ * z
    n_new = fs * n + is_
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def slstm_block_apply(params, x, cfg: ModelConfig, mode: str, cache=None):
    """Returns (y, cache) as ``mlstm_block_apply`` does, the cache
    {"c", "n", "m", "h"}."""
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    xn = L.norm_apply(params["norm"], x, cfg)
    B, S = x.shape[0], x.shape[1]
    zifo_in = (xn @ params["w_zifo"]).float() + params["b_zifo"]   # [B, S, 4d]

    if cache is None:
        carry = (torch.zeros((B, H, P), dtype=torch.float32, device=x.device),
                 torch.zeros((B, H, P), dtype=torch.float32, device=x.device),
                 torch.full((B, H), -1e30, dtype=torch.float32, device=x.device),
                 torch.zeros((B, H, P), dtype=torch.float32, device=x.device))
    else:
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])

    r = params["r_zifo"].float()
    hs = []
    for t in range(S):
        rec = torch.einsum("bhp,hpq->bhq", carry[3], r).reshape(B, -1)
        carry = _slstm_cell(carry, zifo_in[:, t] + rec, H, P)
        hs.append(carry[3])
    hs = torch.stack(hs, dim=1)                                  # [B, S, H, P]

    new_cache = None
    if mode == "decode":
        for key, t in zip("cnmh", carry):
            cache[key].copy_(t)
        new_cache = cache
    elif mode == "prefill":
        new_cache = dict(zip("cnmh", carry))

    hs = hs.reshape(B, S, d).to(x.dtype)
    hs = _rms(hs, x.dtype) * params["out_norm"]["scale"]
    up = hs @ params["w_up"]
    hs = F.silu(up[..., :d]) * up[..., d:]
    return x + hs @ params["w_down"], new_cache
