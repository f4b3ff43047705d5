"""Helpers of the parity tests that hold the port's LM families against the
reference on the CPU (``test_torch_moe.py``, ``test_torch_xlstm.py``,
``test_torch_encdec.py``): the reference's parameters converted to the
port's tree, tolerance checks over nested caches, the reference's cache
splice, and one run of train, prefill and decode steps through both
packages on the same inputs.

Tolerances (the callers pass them): logits within 1e-4 of their largest
magnitude, caches within 1e-5 of theirs, as in ``test_torch_serve.py``.
"""
import functools

import jax
import numpy as np
import torch

from repro.models import model as RM
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import model as M


@functools.lru_cache(maxsize=8)
def _ref_init(rcfg, seed: int):
    # jitted: the eager init of a reduced xLSTM takes ~9 s on one core
    return jax.jit(lambda k: RM.init_params(k, rcfg))(jax.random.PRNGKey(seed))


def ref_params(rcfg, seed: int = 0):
    """The reference's parameters (its ``init_params`` under ``jax.jit``,
    kept per configuration and seed) and their conversion to the port,
    fresh tensors each call."""
    jp = _ref_init(rcfg, seed)
    return jp, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def close(got, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def close_tree(got, want, tol: float) -> None:
    """Same keys, None where the reference has None, shapes equal, leaves
    within ``tol`` of their largest magnitude."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], tol)
        return
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    close(got, want, tol)


def same_layout(got, want) -> None:
    """Same keys, None where the reference has None, and each leaf's
    shape and dtype (the reference's as a jax ShapeDtypeStruct or array)."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            same_layout(got[k], want[k])
        return
    assert tuple(got.shape) == tuple(want.shape), (tuple(got.shape), want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), \
        (got.dtype, want.dtype)


def ref_splice(big, small):
    def one(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return dst.at[tuple(slice(0, s) for s in src.shape)].set(src)
    return jax.tree_util.tree_map(one, big, small)


def serve_both(rcfg, cfg, jp, tp, jb, tb, S: int, extra: int, B: int):
    """Prefill S positions and decode ``extra`` more through both packages:
    the prefill's logits and cache, each decode step's logits and the
    cache after the last step held against the reference's. ``jb(a, b)``
    and ``tb(a, b)`` give each package's batch of positions [a, b)."""
    want, jc = RM.prefill(jp, jb(0, S), rcfg)
    got, tc = M.prefill(tp, tb(0, S), cfg)
    close(got, want, 1e-4)
    close_tree(tc, jc, 1e-5)

    jc = ref_splice(RM.init_cache(rcfg, B, S + extra), jc)
    tc = serve.splice_cache(M.init_cache(cfg, B, S + extra, "cpu"), tc)
    # one trace for every step, the index traced (as the reference's serve
    # driver jits its decode step)
    ref_decode = jax.jit(lambda p, b, c, i: RM.decode_step(p, b, c, i, rcfg))
    for i in range(extra):
        want, jc = ref_decode(jp, jb(S + i, S + i + 1), jc, S + i)
        got, tc = M.decode_step(tp, tb(S + i, S + i + 1), tc, S + i, cfg)
        close(got, want, 1e-4)
    close_tree(tc, jc, 1e-5)


def own_prefill_then_decode(cfg, seed: int, S: int, extra: int, B: int,
                            batch_of=None):
    """The port's own init; prefill S tokens, decode ``extra`` more; the
    decoded logits and the parallel forward's at the same positions (the
    reference's ``_prefill_then_decode_logits``, on the port).
    ``batch_of(tokens)`` adds what the family needs besides the tokens."""
    gen = torch.Generator().manual_seed(seed)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S + extra), generator=gen)
    batch_of = batch_of or (lambda t: {"tokens": t})
    full, _ = M.forward(params, batch_of(toks), cfg, mode="train")
    _, cache = M.prefill(params, batch_of(toks[:, :S]), cfg)
    cache = serve.splice_cache(M.init_cache(cfg, B, S + extra, "cpu"), cache)
    outs = []
    for i in range(extra):
        lg, cache = M.decode_step(params, {"tokens": toks[:, S + i:S + i + 1]},
                                  cache, S + i, cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), full[:, S:S + extra]
