"""The port's transformer serving path on the CPU (``repro_torch.models.
transformer``, ``models.model`` and ``launch.serve``) against the
reference, for each of the five archs whose family routes to the dense
transformer, at ``reduced()`` size: the reference's ``init_params``
converted with ``lm_params_from_jax``, then ``forward`` (train), ``prefill``
(logits and k/v cache) and 4 ``decode_step``s, each held against the
reference's on the same inputs. Then the port on its own: decode against
the parallel forward, the sliding window's reach, its initializer in
distribution, and the serve CLI.

Tolerance: logits within 1e-4 of their largest magnitude (two layers of
float32 products summed in other orders by XLA and torch; measured
~1e-6), the cache within 1e-5; the port's own decode against its parallel
forward 2e-3, the reference's bound in test_decode_matches_parallel_dense.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["gemma-2b", "olmo-1b", "glm4-9b", "qwen2-72b", "qwen2-vl-2b"]
B, S, EXTRA = 2, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _inputs(cfg, seed, n):
    """n positions of token ids, or embeddings for the vlm: numpy, and as
    each package's batch dicts."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        e = (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(np.float32)
        return (lambda a, b: {"embeds": jnp.asarray(e[:, a:b])},
                lambda a, b: {"embeds": torch.tensor(e[:, a:b])})
    t = rng.integers(0, cfg.vocab_size, (B, n))
    return (lambda a, b: {"tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"tokens": torch.tensor(t[:, a:b])})


def _ref_splice(big, small):
    def one(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return dst.at[tuple(slice(0, s) for s in src.shape)].set(src)
    return jax.tree_util.tree_map(one, big, small)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_prefill_decode_match_reference(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    jp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert M.count_params(tp) == RM.count_params(jp)
    jb, tb = _inputs(cfg, 1, S + EXTRA)

    want, _, _ = RM.forward(jp, jb(0, S + EXTRA), rcfg, mode="train")
    got, cache = M.forward(tp, tb(0, S + EXTRA), cfg, mode="train")
    assert cache is None
    _close(got, want, 1e-4)

    want, jc = RM.prefill(jp, jb(0, S), rcfg)
    got, tc = M.prefill(tp, tb(0, S), cfg)
    _close(got, want, 1e-4)
    assert set(tc) == set(jc)
    for k in jc:
        _close(tc[k], jc[k], 1e-5)

    jc = _ref_splice(RM.init_cache(rcfg, B, S + EXTRA), jc)
    tc = serve.splice_cache(M.init_cache(cfg, B, S + EXTRA, "cpu"), tc)
    for i in range(EXTRA):
        want, jc = RM.decode_step(jp, jb(S + i, S + i + 1), jc, S + i, rcfg)
        got, tc = M.decode_step(tp, tb(S + i, S + i + 1), tc, S + i, cfg)
        _close(got, want, 1e-4)
    for k in jc:
        _close(tc[k], jc[k], 1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "glm4-9b"])
def test_lm_loss_matches_reference(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    jp = RM.init_params(jax.random.PRNGKey(2), rcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = _inputs(cfg, 3, 16)
    want = float(RM.loss_fn(jp, jb(0, 16), rcfg))
    got = float(M.loss_fn(tp, tb(0, 16), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def _own_prefill_then_decode(cfg, seed):
    """The port's own init; prefill S tokens, decode EXTRA more; each
    decoded logit against the parallel forward over the whole sequence
    (the reference's _prefill_then_decode_logits, on the port)."""
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S + EXTRA), generator=gen)
    full, _ = M.forward(params, {"tokens": toks}, cfg, mode="train")
    _, cache = M.prefill(params, {"tokens": toks[:, :S]}, cfg)
    cache = serve.splice_cache(M.init_cache(cfg, B, S + EXTRA, "cpu"), cache)
    outs = []
    for i in range(EXTRA):
        lg, cache = M.decode_step(params, {"tokens": toks[:, S + i:S + i + 1]},
                                  cache, S + i, cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), full[:, S:S + EXTRA]


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma-2b", "glm4-9b", "qwen2-72b"])
def test_decode_matches_parallel_dense(arch):
    got, want = _own_prefill_then_decode(get_arch(arch).reduced(), 0)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_prefill_with_use_pallas_matches_plain():
    """prefill(use_pallas=True) on the CPU takes the flash wrapper's plain
    version, which must agree with the layer's own attention path."""
    cfg = get_arch("gemma-2b").reduced()
    gen = torch.Generator().manual_seed(4)
    params = M.init_params(gen, cfg, "cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
    a, ca = M.prefill(params, toks, cfg, use_pallas=True)
    b, cb = M.prefill(params, toks, cfg)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ca["k"], cb["k"], rtol=0, atol=0)


def test_sliding_window_restricts_attention():
    """With a window of w, token t is unaffected by tokens < t - w (the
    reference's test of the same name, on the port)."""
    cfg = get_arch("gemma-2b").reduced(sliding_window=8, num_layers=1)
    gen = torch.Generator().manual_seed(4)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    lg1, _ = M.forward(params, {"tokens": toks}, cfg, mode="train")
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
    lg2, _ = M.forward(params, {"tokens": toks2}, cfg, mode="train")
    torch.testing.assert_close(lg1[0, 10:], lg2[0, 10:], rtol=1e-4, atol=1e-5)
    assert float((lg1[0, 1] - lg2[0, 1]).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ["gemma-2b", "glm4-9b"])
def test_own_init_in_distribution(arch):
    """The port's initializer: the reference's tree (keys, shapes, dtypes),
    dense weights N(0, 1/in), the embedding N(0, 0.02^2), norm scales 1 and
    biases 0. Standard deviations within 5% (each leaf has >= 16k
    draws: the sample std's relative error is ~1/sqrt(2n) < 0.6%)."""
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")

    def walk(r, t, path):
        assert set(r) == set(t), path
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], t[k], path + (k,))
                continue
            leaf = t[k]
            assert tuple(leaf.shape) == r[k].shape and leaf.dtype == torch.float32
            if k == "tok":
                assert abs(float(leaf.std()) / 0.02 - 1) < 0.05
            elif k.startswith("w") or k == "unembed":
                fan_in = leaf.shape[-2]
                assert abs(float(leaf.std()) * fan_in ** 0.5 - 1) < 0.05, path + (k,)
                assert abs(float(leaf.mean())) < 0.05 / fan_in ** 0.5
            elif k == "scale":
                assert bool((leaf == 1).all())
            else:
                assert bool((leaf == 0).all()), path + (k,)
    walk(ref, params, ())


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--arch", "gemma-2b"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve] OK" in r.stdout and "[serve] prefill 4x64" in r.stdout


def test_serve_driver_returns_its_tokens_and_times():
    res = serve.run(["--device", "cpu", "--arch", "qwen2-vl-2b", "--batch", "2",
                     "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["prefill_logits"].shape == (2, 8, res["cfg"].vocab_size)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                                  "xlstm-1.3b", "whisper-medium"])
def test_arch_serves_on_cpu(arch):
    """The serve CLI's run of the MoE, xLSTM and encoder-decoder archs at
    reduced() size: B tokens of gen, prefill logits [B, prompt, V], every
    logit finite."""
    res = serve.run(["--device", "cpu", "--arch", arch, "--batch", "2",
                     "--prompt-len", "16", "--gen", "3"])
    V = res["cfg"].vocab_size
    assert res["cfg"] == get_arch(arch).reduced()
    assert tuple(res["tokens"].shape) == (2, 3)
    assert tuple(res["prefill_logits"].shape) == (2, 16, V)
    assert tuple(res["logits"].shape) == (2, 1, V)
    assert bool(torch.isfinite(res["prefill_logits"]).all())
    assert bool(torch.isfinite(res["logits"]).all())


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.run(["--arch", "olmo-1b"])


def test_registry_copies_the_reference_configs():
    from repro.configs.registry import ARCHS as REF_ARCHS
    from repro.configs.registry import get_arch as ref_get
    assert set(ARCHS) == set(REF_ARCHS)
    for name, cfg in ARCHS.items():
        ref = REF_ARCHS[name]
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "norm_type", "mlp_type",
                  "tie_embeddings", "embed_scale", "rope_theta", "use_mrope",
                  "mrope_sections", "qkv_bias", "sliding_window", "family",
                  "embedding_inputs", "param_dtype", "compute_dtype",
                  "ssm_state", "ssm_heads", "ssm_expand", "ssm_conv_width",
                  "ssm_chunk", "shared_attn_every", "is_subquadratic",
                  "learned_pos_emb", "num_experts", "num_experts_per_tok",
                  "num_shared_experts", "moe_d_ff", "first_dense_layers",
                  "capacity_factor", "router_aux_weight", "slstm_every",
                  "is_encoder_decoder", "num_encoder_layers",
                  "encoder_seq_len"):
            assert getattr(cfg, f) == getattr(ref, f), (name, f)
            assert getattr(cfg.reduced(), f) == getattr(ref.reduced(), f), (name, f)
        assert cfg.reduced().resolved_head_dim == ref.reduced().resolved_head_dim
        assert cfg.reduced().num_kv_heads == ref.reduced().num_kv_heads
    for arch in ("gemma-2b", "zamba2-7b"):
        assert get_arch(arch, "long_500k").sliding_window == \
            ref_get(arch, "long_500k").sliding_window == 4096
        assert get_arch(arch, "long_500k").name == ref_get(arch, "long_500k").name
