"""The port's MoE family on the CPU (``repro_torch.models.moe``,
``models.moe_transformer`` and the moe branch of ``models.model``) against
the reference: ``route`` on the same router logits (a row of tied logits
and a capacity that drops tokens among them), ``moe_apply``, and
deepseek-moe-16b (one leading dense block) and qwen3-moe-235b-a22b (no
dense block: the cache's "dense" is None) at ``reduced()``, the
reference's ``init_params`` converted with ``lm_params_from_jax``: train
logits and aux, prefill logits and cache, 4 decode steps, and the loss
with its aux term. Then the port on its own: its init's tree against the
reference's, decode against its parallel forward, the group split.

Tolerances: ``route``'s dispatch bitwise, its combine within 1e-6
relative (8 float32 ULPs: the softmax's exp differs from XLA's by an ULP
in ~9% of elements, and its sum over E and the top-k normalization add a
few more), aux within 1e-6; logits within 1e-4 of their largest magnitude
(measured ~1e-6), caches 1e-5, losses 1e-5 relative; the port's decode
against its parallel forward 5e-3 at capacity_factor 4.0, the reference's
bound in test_decode_matches_parallel_moe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (close, close_tree, own_prefill_then_decode,
                           ref_params, same_layout, serve_both)
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.models import moe_transformer as RMT
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import moe_transformer as MT

MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
B, S, EXTRA = 2, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return ref_get_arch(arch).reduced(**kw), get_arch(arch).reduced(**kw)


def _tokens(cfg, seed, n):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))
    return (lambda a, b: {"tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"tokens": torch.tensor(t[:, a:b])})


# ---- route -----------------------------------------------------------------

ROUTE_CASES = {
    # arch, reduced?, tokens per group, capacity (None: the config's)
    "reduced": ("deepseek-moe-16b", True, 64, None),
    "reduced_drops": ("deepseek-moe-16b", True, 64, 4),
    "deepseek_full": ("deepseek-moe-16b", False, 256, None),
    "qwen3_full_drops": ("qwen3-moe-235b-a22b", False, 128, 6),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_reference(case):
    arch, reduced, gs, cap = ROUTE_CASES[case]
    rcfg, cfg = ((ref_get_arch(arch).reduced(), get_arch(arch).reduced())
                 if reduced else (ref_get_arch(arch), get_arch(arch)))
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = cap or moe._capacity(gs, cfg)
    assert C == (cap or RMoE._capacity(gs, rcfg))
    logits = (2 * np.random.default_rng(0).standard_normal((2, gs, E))
              ).astype(np.float32)
    logits[0, 0] = 0.0                 # every expert tied: the lowest k win
    logits[1, 3, :] = -1.0
    logits[1, 3, [1, 5 % E, 2]] = 1.5  # three tied at the top
    jd, jc, ja = RMoE.route(jnp.asarray(logits), rcfg, C)
    td, tc, ta = moe.route(torch.tensor(logits), cfg, C)
    jd, jc = np.asarray(jd), np.asarray(jc)
    assert td.dtype == torch.bool and td.shape == jd.shape
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the choices, tied rows included, are the reference's: the lower
    # index first among equal probabilities
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    _, tidx = moe.top_k(torch.softmax(torch.tensor(logits), -1), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[0, 0].tolist() == list(range(k))
    if cap is not None:                # the small capacity dropped tokens
        assert int(jd.sum()) < 2 * gs * k


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    assert torch.equal(vals, probs.gather(-1, idx))


def test_moe_apply_matches_reference():
    rcfg, cfg = _cfgs("deepseek-moe-16b")
    jp = RMoE.moe_init(jax.random.PRNGKey(3), rcfg, jnp.float32)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)
                                                 ).astype(np.float32)
    jy, ja = RMoE.moe_apply(jp, jnp.asarray(x), rcfg)
    ty, ta = moe.moe_apply(tp, torch.tensor(x), cfg)
    close(ty, jy, 1e-4)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_apply_raises_on_a_ragged_group():
    cfg = get_arch("deepseek-moe-16b").reduced()
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                          "cpu")
    moe.moe_apply(params, torch.zeros(2, 256, cfg.d_model), cfg)  # 2 groups
    with pytest.raises(ValueError, match="routing groups of 256"):
        moe.moe_apply(params, torch.zeros(3, 100, cfg.d_model), cfg)


# ---- the models --------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_prefill_decode_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    jp, tp = ref_params(rcfg)
    assert M.count_params(tp) == RM.count_params(jp)
    assert ("dense_blocks" in tp) == (arch == "deepseek-moe-16b")
    jb, tb = _tokens(cfg, 1, S + EXTRA)

    want, _, jaux = RMT.forward(jp, jb(0, S + EXTRA), rcfg, mode="train")
    got, cache, taux = MT.forward(tp, tb(0, S + EXTRA), cfg, mode="train")
    assert cache is None
    close(got, want, 1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    got, cache = M.forward(tp, tb(0, S + EXTRA), cfg, mode="train")
    close(got, want, 1e-4)

    _, tc = M.prefill(tp, tb(0, S), cfg)
    assert (tc["dense"] is None) == (arch == "qwen3-moe-235b-a22b")
    serve_both(rcfg, cfg, jp, tp, jb, tb, S, EXTRA, B)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_with_its_aux_term_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    jp, tp = ref_params(rcfg)
    jb, tb = _tokens(cfg, 3, 16)
    want = float(RM.loss_fn(jp, jb(0, 16), rcfg))
    got = float(M.loss_fn(tp, tb(0, 16), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the aux term is in it: without its weight the loss is the CE alone
    no_aux = float(M.loss_fn(tp, tb(0, 16), cfg.replace(router_aux_weight=0.0)))
    _, _, aux = MT.forward(tp, tb(0, 16), cfg, mode="train")
    assert abs(got - no_aux - 0.01 * float(aux)) <= 1e-6 * abs(got)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_own_init_and_cache_have_the_references_layout(arch):
    rcfg, cfg = _cfgs(arch)
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    same_layout(params, ref)
    assert params["moe_blocks"]["moe"]["router"].dtype == torch.float32
    same_layout(M.init_cache(cfg, B, 40, "cpu"), RM.init_cache(rcfg, B, 40))


def test_own_init_in_distribution():
    """Router and expert weights N(0, 1/in) (each leaf has >= 16k draws:
    the sample std's relative error is < 0.6%; bound 5%)."""
    cfg = get_arch("deepseek-moe-16b").reduced()
    p = M.init_params(torch.Generator().manual_seed(6), cfg, "cpu")["moe_blocks"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        leaf = p["moe"][name]
        fan_in = leaf.shape[-2]
        assert abs(float(leaf.std()) * fan_in ** 0.5 - 1) < 0.05, name


def test_decode_matches_parallel_moe():
    cfg = get_arch("deepseek-moe-16b").reduced(capacity_factor=4.0)
    got, want = own_prefill_then_decode(cfg, 1, S, EXTRA, B)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
