"""The port's xLSTM family on the CPU (``repro_torch.models.xlstm``,
``models.xlstm_model`` and the xlstm branch of ``models.model``) against
the reference: the chunked mLSTM at several chunks with and without an
initial state, its decode step, the sLSTM block in prefill and in decode,
and xlstm-1.3b at ``reduced()`` (one super-block of one mLSTM and one
sLSTM block, a single chunk), ``reduced(ssm_chunk=8)`` (three chunks: the
inter-chunk recurrence runs) and ``reduced(num_layers=3)`` (a remainder
mLSTM block), the reference's ``init_params`` converted with
``lm_params_from_jax``: train, prefill (logits and states) and 4 decode
steps, and the loss. Then the port on its own: the init and cache
layouts, decode against the parallel forward, the chunk's divisibility.

Tolerances: the mLSTM and sLSTM outputs and states within 1e-5 of their
largest magnitude (float32 products summed in other orders); logits 1e-4
(measured ~1e-6), caches 1e-5, the loss 1e-5 relative; the port's decode
against its parallel forward 1e-2, the reference's bound in
test_decode_matches_parallel_xlstm.
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
from repro.models import xlstm as RX
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as M
from repro_torch.models import xlstm as X
from repro_torch.models import xlstm_model

B, S, EXTRA = 2, 24, 4
LAYOUTS = {"reduced": {}, "chunk8": {"ssm_chunk": 8},
           "remainder": {"num_layers": 3, "ssm_chunk": 8}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(layout):
    kw = LAYOUTS[layout]
    return (ref_get_arch("xlstm-1.3b").reduced(**kw),
            get_arch("xlstm-1.3b").reduced(**kw))


def _tokens(cfg, seed, n):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))
    return (lambda a, b: {"tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"tokens": torch.tensor(t[:, a:b])})


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays])


def _mlstm_inputs(seed, S_len, H=2, dk=8, dv=16):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f32(B, S_len, H, dk) / np.sqrt(dk), f32(B, S_len, H, dk),
            f32(B, S_len, H, dv), f32(B, S_len, H), 2 + f32(B, S_len, H))


def _state(seed, H=2, dk=8, dv=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, dk, dv)).astype(np.float32),
            rng.standard_normal((B, H, dk)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("initial", [False, True])
def test_mlstm_chunked_matches_reference(chunk, initial):
    (jq, jk, jv, ji, jf), (tq, tk, tv, ti, tf) = _both(*_mlstm_inputs(0, S))
    j0 = t0 = None
    if initial:
        j0, t0 = _both(*_state(1))
    jh, jst = RX._mlstm_chunked(jq, jk, jv, ji, jf, chunk, initial=j0)
    th, tst = X._mlstm_chunked(tq, tk, tv, ti, tf, chunk, initial=t0)
    close(th, jh, 1e-5)
    for t, j in zip(tst, jst):
        close(t, j, 1e-5)


def test_mlstm_chunked_refuses_a_ragged_chunk():
    tq, tk, tv, ti, tf = (torch.tensor(a) for a in _mlstm_inputs(0, 20))
    with pytest.raises(ValueError, match="multiple of its chunk 8"):
        X._mlstm_chunked(tq, tk, tv, ti, tf, 8)


def test_mlstm_decode_step_matches_reference():
    (jq, jk, jv, ji, jf), (tq, tk, tv, ti, tf) = _both(*_mlstm_inputs(2, 1))
    js, ts = _both(*_state(3))
    jh, jst = RX.mlstm_decode_step(jq[:, 0], jk[:, 0], jv[:, 0], ji[:, 0],
                                   jf[:, 0], tuple(js))
    th, tst = X.mlstm_decode_step(tq[:, 0], tk[:, 0], tv[:, 0], ti[:, 0],
                                  tf[:, 0], tuple(ts))
    close(th, jh, 1e-5)
    for t, j in zip(tst, jst):
        close(t, j, 1e-5)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_slstm_block_matches_reference(mode):
    _, cfg = _cfgs("reduced")
    jp = RX.slstm_block_init(jax.random.PRNGKey(4), cfg, jnp.float32)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    S_len = 1 if mode == "decode" else S
    x = np.random.default_rng(5).standard_normal((B, S_len, cfg.d_model)
                                                 ).astype(np.float32)
    jc = tc = None
    if mode == "decode":   # a state reached by a prefill of 5 steps
        x5 = np.random.default_rng(6).standard_normal((B, 5, cfg.d_model)
                                                      ).astype(np.float32)
        _, jc = RX.slstm_block_apply(jp, jnp.asarray(x5), cfg, "prefill")
        tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    jy, jc2 = RX.slstm_block_apply(jp, jnp.asarray(x), cfg, mode, cache=jc)
    ty, tc2 = X.slstm_block_apply(tp, torch.tensor(x), cfg, mode, cache=tc)
    close(ty, jy, 1e-5)
    close_tree(tc2, jc2, 1e-5)
    if mode == "decode":
        assert tc2 is tc       # written in place


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_prefill_decode_match_reference(layout):
    rcfg, cfg = _cfgs(layout)
    assert xlstm_model.split_layers(cfg) == \
        ((2, 1, 1) if layout == "remainder" else (2, 1, 0))
    jp, tp = ref_params(rcfg)
    assert M.count_params(tp) == RM.count_params(jp)
    jb, tb = _tokens(cfg, 1, S + EXTRA)

    want, _, _ = RM.forward(jp, jb(0, S), rcfg, mode="train")
    got, cache = M.forward(tp, tb(0, S), cfg, mode="train")
    assert cache is None
    close(got, want, 1e-4)
    serve_both(rcfg, cfg, jp, tp, jb, tb, S, EXTRA, B)


def test_loss_matches_reference():
    rcfg, cfg = _cfgs("chunk8")
    jp, tp = ref_params(rcfg)
    jb, tb = _tokens(cfg, 3, 16)
    want = float(RM.loss_fn(jp, jb(0, 16), rcfg))
    got = float(M.loss_fn(tp, tb(0, 16), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("layout", ["reduced", "remainder"])
def test_own_init_and_cache_have_the_references_layout(layout):
    rcfg, cfg = _cfgs(layout)
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    same_layout(params, ref)
    assert params["mlstm"]["w_q"].shape[:2] == (1, 1)   # [n_super, r - 1]
    cache = M.init_cache(cfg, B, 40, "cpu")
    same_layout(cache, RM.init_cache(rcfg, B, 40))
    assert bool((cache["mlstm"]["m"] == -1e30).all())


def test_pure_mlstm_stack_routes_to_xlstm():
    """slstm_every = 0 and no Mamba2 state: every layer an mLSTM block, in
    the remainder stack (the reference's split)."""
    cfg = get_arch("xlstm-1.3b").reduced(slstm_every=0)
    assert xlstm_model.split_layers(cfg) == (0, 0, 2)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(params) == {"embed", "final_norm", "mlstm_rem"}
    cache = M.init_cache(cfg, B, 8, "cpu")
    assert cache["mlstm"] is None and cache["slstm"] is None


def test_decode_matches_parallel_xlstm():
    # chunk 4 divides both the prompt (24) and the whole sequence (28)
    cfg = get_arch("xlstm-1.3b").reduced(ssm_chunk=4)
    got, want = own_prefill_then_decode(cfg, 3, S, EXTRA, B)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_prefill_of_a_ragged_prompt_raises():
    cfg = get_arch("xlstm-1.3b").reduced(ssm_chunk=8)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((B, 20), dtype=torch.int64)
    with pytest.raises(ValueError, match="chunk 8"):
        M.prefill(params, {"tokens": toks}, cfg)
