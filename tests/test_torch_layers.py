"""The port's LM layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the CPU, part by part: norms,
RoPE and M-RoPE, attention in train, prefill and decode (the full cache and
the sliding window's ring buffer, the plain and the chunked S > 1024
paths), the MLPs, embeddings and cross attention. Parameters are the
reference's init converted with ``lm_params_from_jax`` (biases and norm
scales replaced by random numbers so they count); inputs come from numpy.

Tolerance: float32 throughout. Elementwise parts (norms, rotations,
embeddings) within 1e-5 relative; parts with matrix products, whose sums
XLA and torch order differently, within 1e-5 of the output's scale (2e-5
for attention, whose softmax adds an exp and a second product).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import model as M


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return ref_get_arch(arch).reduced(**kw), get_arch(arch).reduced(**kw)


def _randomize(tree, rng, names=("bq", "bk", "bv", "scale", "bias")):
    """The reference's tree as numpy, with its zero/one leaves named in
    ``names`` replaced by random numbers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, names)
        else:
            a = np.asarray(v)
            out[k] = (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if k in names else a)
    return out


def _close(got, want, tol, scale=None):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    atol = tol * (float(np.abs(want).max()) if scale is None else scale)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# ---------------------------------------------------------------------------
# norms and rotations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norm_matches_reference(norm_type):
    rcfg, cfg = _cfgs("gemma-2b", norm_type=norm_type)
    rng = np.random.default_rng(0)
    p = _randomize(jax.tree_util.tree_map(np.asarray,
                                          RL.norm_init(rcfg, jnp.float32)), rng)
    x = (3.0 * rng.standard_normal((2, 7, cfg.d_model)) + 0.5).astype(np.float32)
    want = RL.norm_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), rcfg)
    got = L.norm_apply(lm_params_from_jax(p, "cpu"), torch.tensor(x), cfg)
    _close(got, want, 1e-5, scale=1.0)
    assert (p == {}) == (norm_type == "nonparametric_ln")


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 16))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    # angles up to 5000 rad: XLA's and torch's cos/sin of a large float32
    # angle differ by a few ULP of the result
    _close(got, want, 2e-5, scale=1.0)


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_mrope_matches_reference(hd):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    thw = rng.integers(0, 64, (3, 2, 12))
    secs = (16, 24, 24)
    assert L.mrope_sections_for(hd, secs) == RL.mrope_sections_for(hd, secs)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(thw, jnp.int32), 1e6, secs)
    got = L.apply_mrope(torch.tensor(x), torch.tensor(thw), 1e6, secs)
    _close(got, want, 1e-5, scale=1.0)


def test_mrope_collapses_to_rope_for_text():
    """Equal (t,h,w) position ids reproduce plain RoPE (the reference's
    test_mrope_collapses_to_rope_for_text, on the port)."""
    x = torch.tensor(np.random.default_rng(5).standard_normal((2, 16, 4, 64)),
                     dtype=torch.float32)
    pos = torch.arange(16)[None].expand(2, 16)
    plain = L.apply_rope(x, pos, 10000.0)
    mr = L.apply_mrope(x, torch.stack([pos, pos, pos]), 10000.0, (16, 24, 24))
    torch.testing.assert_close(mr, plain, rtol=1e-5, atol=1e-5)


def test_mrope_distinguishes_spatial_positions():
    x = torch.tensor(np.random.default_rng(6).standard_normal((1, 4, 2, 64)),
                     dtype=torch.float32)
    t = torch.zeros((1, 4), dtype=torch.long)
    h1 = torch.tensor([[0, 1, 2, 3]])
    a = L.apply_mrope(x, torch.stack([t, h1, t]), 1e4, (16, 24, 24))
    b = L.apply_mrope(x, torch.stack([t, t, h1]), 1e4, (16, 24, 24))
    assert float((a - b).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_params(rcfg, seed):
    p = RL.attention_init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    p = _randomize(jax.tree_util.tree_map(np.asarray, p),
                   np.random.default_rng(seed))
    return p, lm_params_from_jax(p, "cpu")


def _positions(rcfg, B, S, offset=0):
    p = np.broadcast_to(np.arange(S) + offset, (B, S))
    if rcfg.use_mrope:
        p = np.stack([p, p, p])
    return jnp.asarray(p, jnp.int32), torch.tensor(np.ascontiguousarray(p))


@pytest.mark.parametrize("arch", ["gemma-2b", "glm4-9b", "qwen2-vl-2b", "olmo-1b"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attention_apply_matches_reference(arch, mode):
    rcfg, cfg = _cfgs(arch)
    jp, tp = _attn_params(rcfg, 7)
    x = (0.5 * np.random.default_rng(8).standard_normal((2, 40, cfg.d_model))
         ).astype(np.float32)
    jpos, tpos = _positions(rcfg, 2, 40)
    want, wcache = RL.attention_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                      jnp.asarray(x), rcfg, jpos, mode=mode)
    got, gcache = L.attention_apply(tp, torch.tensor(x), cfg, tpos, mode=mode)
    _close(got, want, 2e-5)
    if mode == "prefill":
        for k in ("k", "v"):
            _close(gcache[k], wcache[k], 1e-5)
    else:
        assert gcache is None and wcache is None


@pytest.mark.parametrize("window", [None, 1500])
def test_chunked_attention_matches_reference(window):
    """S = 2048 > 1024 takes the chunked path in both packages (two query
    blocks of 1024; with a window of 1500 the second block starts at key
    548), at a narrow width."""
    rcfg, cfg = _cfgs("glm4-9b", d_model=32, num_heads=2, num_kv_heads=1,
                      sliding_window=window)
    jp, tp = _attn_params(rcfg, 9)
    x = np.random.default_rng(10).standard_normal((1, 2048, 32)).astype(np.float32)
    jpos, tpos = _positions(rcfg, 1, 2048)
    want, _ = RL.attention_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                 jnp.asarray(x), rcfg, jpos, mode="train")
    got, _ = L.attention_apply(tp, torch.tensor(x), cfg, tpos, mode="train")
    _close(got, want, 2e-5)
    plain = L._plain_causal_attention(*_qkv(tp, torch.tensor(x), cfg, tpos), cfg)
    chunked = L._chunked_causal_attention(*_qkv(tp, torch.tensor(x), cfg, tpos), cfg)
    torch.testing.assert_close(chunked, plain, rtol=1e-5, atol=1e-5)


def _qkv(p, x, cfg, pos):
    q, k, v = L._project_qkv(p, x, cfg)
    q, k = L._rotate(q, k, cfg, pos)
    return q, k, v


@pytest.mark.parametrize("arch,window", [("gemma-2b", None), ("glm4-9b", 8),
                                         ("qwen2-vl-2b", None)])
def test_decode_attention_matches_reference(arch, window):
    """12 single-token decode steps from an empty cache, step by step in
    both packages: the full cache, and with a window of 8 the ring buffer,
    which wraps after 8 steps."""
    rcfg, cfg = _cfgs(arch, sliding_window=window)
    jp, tp = _attn_params(rcfg, 11)
    jpj = jax.tree_util.tree_map(jnp.asarray, jp)
    n = 12
    xs = (0.5 * np.random.default_rng(12).standard_normal((n, 2, 1, cfg.d_model))
          ).astype(np.float32)
    jc = jax.tree_util.tree_map(lambda a: a[0], RM.init_cache(rcfg, 2, n + 4))
    tc = {k: v[0] for k, v in M.init_cache(cfg, 2, n + 4, "cpu").items()}
    assert ("pos" in tc) == (window is not None) == ("pos" in jc)
    for i in range(n):
        jpos, tpos = _positions(rcfg, 2, 1, offset=i)
        want, jc = RL.attention_apply(jpj, jnp.asarray(xs[i]), rcfg, jpos,
                                      mode="decode", cache=jc, cache_index=i)
        got, tc = L.attention_apply(tp, torch.tensor(xs[i]), cfg, tpos,
                                    mode="decode", cache=tc, cache_index=i)
        _close(got, want, 2e-5)
    for k in jc:
        _close(tc[k], jc[k], 1e-5, scale=1.0)


# ---------------------------------------------------------------------------
# MLP, embeddings, cross attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    rcfg, cfg = _cfgs("olmo-1b", mlp_type=mlp_type)
    jp = jax.tree_util.tree_map(
        np.asarray, RL.mlp_init(jax.random.PRNGKey(13), rcfg, jnp.float32))
    x = np.random.default_rng(14).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = RL.mlp_apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), rcfg)
    got = L.mlp_apply(lm_params_from_jax(jp, "cpu"), torch.tensor(x), cfg)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "glm4-9b"])   # tied + scaled; untied
def test_embed_unembed_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    jp = jax.tree_util.tree_map(
        np.asarray, RL.embed_init(jax.random.PRNGKey(15), rcfg, jnp.float32))
    assert ("unembed" in jp) == (not cfg.tie_embeddings)
    tp = lm_params_from_jax(jp, "cpu")
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 10))
    want = RL.embed_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                          jnp.asarray(toks, jnp.int32), rcfg)
    got = L.embed_apply(tp, torch.tensor(toks), cfg)
    _close(got, want, 1e-6, scale=1.0)
    h = np.random.default_rng(17).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    want = RL.unembed_apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(h), rcfg)
    got = L.unembed_apply(tp, torch.tensor(h), cfg)
    _close(got, want, 1e-5)


def test_cross_attention_matches_reference():
    rcfg, cfg = _cfgs("glm4-9b")
    jp = jax.tree_util.tree_map(np.asarray, RL.cross_attention_init(
        jax.random.PRNGKey(18), rcfg, jnp.float32))
    assert "bq" not in jp
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want = RL.cross_attention_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                    jnp.asarray(x), jnp.asarray(enc), rcfg)
    got = L.cross_attention_apply(lm_params_from_jax(jp, "cpu"), torch.tensor(x),
                                  torch.tensor(enc), cfg)
    _close(got, want, 2e-5)
