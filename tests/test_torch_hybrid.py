"""The port's zamba2 hybrid on the CPU (``repro_torch.models.ssm``,
``models.hybrid``, the hybrid branch of ``models.model`` and the serve
driver) against the reference, at ``reduced()`` (two Mamba2 layers and one
shared-attention application: n_super 1, n_rem 0) and at
``reduced(num_layers=5)`` (n_super 2, n_rem 1): the reference's
``init_params`` converted with ``lm_params_from_jax``, then ``forward``
(train), ``prefill`` (logits and caches) and 4 ``decode_step``s, with
``use_pallas`` off (ssd_chunked) and on (the ssd_scan wrapper, whose CPU
path is the plain version), each held against the reference's on the same
inputs. Then the port on its own: one Mamba2 block in all three modes,
decode against the parallel forward, the cache layout, the prefill's conv
cache, the initializer and the serve CLI.

Tolerance: logits within 1e-4 of their largest magnitude (two to five
layers of float32 products summed in other orders by XLA and torch;
measured ~2e-6), caches within 1e-5 of theirs; the port's own decode
against its parallel forward 2e-3, the reference's bound in
test_decode_matches_parallel_dense.
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
from repro.models import ssm as RS
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import hybrid
from repro_torch.models import model as M
from repro_torch.models import ssm as S

ROOT = Path(__file__).resolve().parents[1]
B, SQ, EXTRA = 2, 24, 4
LAYOUTS = {"n_rem0": {}, "n_rem1": {"num_layers": 5}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(layout):
    kw = LAYOUTS[layout]
    return ref_get_arch("zamba2-7b").reduced(**kw), get_arch("zamba2-7b").reduced(**kw)


def _params(rcfg, seed=0):
    jp = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    return jp, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _tokens(cfg, seed, n):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))
    return (lambda a, b: {"tokens": jnp.asarray(t[:, a:b], jnp.int32)},
            lambda a, b: {"tokens": torch.tensor(t[:, a:b])})


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _close_tree(got, want, tol):
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k], tol)
        return
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    _close(got, want, tol)


def _ref_splice(big, small):
    def one(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return dst.at[tuple(slice(0, s) for s in src.shape)].set(src)
    return jax.tree_util.tree_map(one, big, small)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_train_prefill_decode_match_reference(layout, use_pallas):
    rcfg, cfg = _cfgs(layout)
    k, n_super, n_rem = hybrid.split_layers(cfg)
    assert (k, n_super, n_rem) == ((2, 1, 0) if layout == "n_rem0" else (2, 2, 1))
    jp, tp = _params(rcfg)
    assert M.count_params(tp) == RM.count_params(jp)
    jb, tb = _tokens(cfg, 1, SQ + EXTRA)

    want, _, _ = RM.forward(jp, jb(0, SQ + EXTRA), rcfg, mode="train",
                            use_pallas=use_pallas)
    got, cache = M.forward(tp, tb(0, SQ + EXTRA), cfg, mode="train",
                           use_pallas=use_pallas)
    assert cache is None
    _close(got, want, 1e-4)

    want, jc = RM.prefill(jp, jb(0, SQ), rcfg, use_pallas=use_pallas)
    got, tc = M.prefill(tp, tb(0, SQ), cfg, use_pallas=use_pallas)
    _close(got, want, 1e-4)
    _close_tree(tc, jc, 1e-5)

    jc = _ref_splice(RM.init_cache(rcfg, B, SQ + EXTRA), jc)
    tc = serve.splice_cache(M.init_cache(cfg, B, SQ + EXTRA, "cpu"), tc)
    for i in range(EXTRA):
        want, jc = RM.decode_step(jp, jb(SQ + i, SQ + i + 1), jc, SQ + i, rcfg)
        got, tc = M.decode_step(tp, tb(SQ + i, SQ + i + 1), tc, SQ + i, cfg)
        _close(got, want, 1e-4)
    _close_tree(tc, jc, 1e-5)


def test_loss_matches_reference():
    rcfg, cfg = _cfgs("n_rem1")
    jp, tp = _params(rcfg, seed=2)
    jb, tb = _tokens(cfg, 3, 16)
    want = float(RM.loss_fn(jp, jb(0, 16), rcfg))
    got = float(M.loss_fn(tp, tb(0, 16), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_one_mamba_block_matches_reference(mode):
    """ssm_block_apply alone (one layer's parameters of the converted
    tree), in each mode; decode from a prefilled cache."""
    rcfg, cfg = _cfgs("n_rem0")
    jp, tp = _params(rcfg, seed=3)
    jm = jax.tree_util.tree_map(lambda a: a[0, 0], jp["mamba"])
    tm = {k: (v[0, 0] if not isinstance(v, dict) else {kk: vv[0, 0] for kk, vv in v.items()})
          for k, v in tp["mamba"].items()}
    x = (0.5 * np.random.default_rng(4).standard_normal((B, 32, cfg.d_model))).astype(np.float32)
    if mode == "decode":
        _, jc = RS.ssm_block_apply(jm, jnp.asarray(x[:, :31]), rcfg, "prefill")
        _, tc = S.ssm_block_apply(tm, torch.tensor(x[:, :31]), cfg, "prefill")
        want, jc = RS.ssm_block_apply(jm, jnp.asarray(x[:, 31:]), rcfg, "decode", cache=jc)
        got, tc2 = S.ssm_block_apply(tm, torch.tensor(x[:, 31:]), cfg, "decode", cache=tc)
        assert tc2 is tc  # written in place
        _close_tree(tc, jc, 1e-5)
    else:
        want, jc = RS.ssm_block_apply(jm, jnp.asarray(x), rcfg, mode)
        got, tc = S.ssm_block_apply(tm, torch.tensor(x), cfg, mode)
        _close_tree(tc, jc, 1e-5)
    _close(got, want, 1e-4)


def test_prefill_conv_cache_owns_its_memory():
    """The prefill's conv cache is a copy of the last W - 1 rows, not a view
    that keeps the whole [B, S, 2 d_inner + 2N + H] projection alive."""
    cfg = get_arch("zamba2-7b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg, "cpu")
    blk = hybrid.T.layer(hybrid.T.layer(params["mamba"], 0), 0)
    x = torch.randn((B, 64, cfg.d_model), generator=gen)
    _, c = S.ssm_block_apply(blk, x, cfg, "prefill")
    conv = c["conv"]
    assert conv.shape == (B, cfg.ssm_conv_width - 1, S.dims(cfg)[0] + 2 * cfg.ssm_state)
    assert conv.untyped_storage().nbytes() == conv.numel() * conv.element_size()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_init_cache_has_the_references_layout(layout):
    rcfg, cfg = _cfgs(layout)
    want = RM.init_cache(rcfg, 3, 40)
    got = M.init_cache(cfg, 3, 40, "cpu")

    def walk(g, w):
        if w is None:
            assert g is None
            return
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                walk(g[k], w[k])
            return
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert bool((g == 0).all())
    walk(got, want)


def test_splice_cache_passes_none_through():
    assert serve.splice_cache({"a": None}, {"a": None}) == {"a": None}
    with pytest.raises(ValueError, match="None"):
        serve.splice_cache({"a": None}, {"a": torch.zeros(2)})
    full = {"state": torch.zeros(2, 3), "k": torch.zeros(2, 8)}
    pre = {"state": torch.ones(2, 3), "k": torch.ones(2, 5)}
    out = serve.splice_cache(full, pre)
    assert out["state"] is pre["state"]          # same shape: replaced
    assert float(out["k"][:, :5].sum()) == 10.0 and float(out["k"][:, 5:].sum()) == 0.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_matches_parallel(layout):
    """The port's own init: prefill SQ tokens, decode EXTRA more; each
    decoded logit against the parallel forward over the whole sequence."""
    cfg = get_arch("zamba2-7b").reduced(**LAYOUTS[layout])
    gen = torch.Generator().manual_seed(6)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, SQ + EXTRA), generator=gen)
    full, _ = M.forward(params, {"tokens": toks}, cfg, mode="train")
    _, cache = M.prefill(params, {"tokens": toks[:, :SQ]}, cfg, use_pallas=True)
    cache = serve.splice_cache(M.init_cache(cfg, B, SQ + EXTRA, "cpu"), cache)
    outs = []
    for i in range(EXTRA):
        lg, cache = M.decode_step(params, {"tokens": toks[:, SQ + i:SQ + i + 1]},
                                  cache, SQ + i, cfg)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full[:, SQ:SQ + EXTRA],
                               rtol=2e-3, atol=2e-3)


def test_own_init_matches_the_references_tree():
    """The port's initializer: the reference's tree (keys, shapes, dtypes);
    conv weights N(0, 0.2^2), A_log = log(linspace(1, 16, H)), D and norm
    scales 1, biases 0; dense weights N(0, 1/in) (std within 5%)."""
    rcfg, cfg = _cfgs("n_rem1")
    ref = jax.eval_shape(lambda k: RM.init_params(k, rcfg), jax.random.PRNGKey(0))
    params = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    H = S.dims(cfg)[1]

    def walk(r, t, path):
        assert set(r) == set(t), path
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], t[k], path + (k,))
                continue
            leaf = t[k]
            assert tuple(leaf.shape) == r[k].shape, path + (k,)
            assert str(leaf.dtype).split(".")[-1] == str(r[k].dtype), path + (k,)
            if k == "conv_w":
                assert abs(float(leaf.std()) / 0.2 - 1) < 0.05
            elif k == "A_log":
                want = torch.log(torch.linspace(1.0, 16.0, H))
                torch.testing.assert_close(leaf, want.expand_as(leaf))
            elif k in ("scale", "D"):
                assert bool((leaf == 1).all())
            elif k in ("conv_b", "dt_bias"):
                assert bool((leaf == 0).all())
            elif k.startswith("w") or k == "unembed":
                fan_in = leaf.shape[-2]
                assert abs(float(leaf.std()) * fan_in ** 0.5 - 1) < 0.05, path + (k,)
    walk(ref, params, ())


def test_use_pallas_prefill_matches_the_chunked_path():
    """prefill(use_pallas=True) on the CPU takes the ssd_scan wrapper's plain
    version; it must agree with the blocks' own ssd_chunked path."""
    cfg = get_arch("zamba2-7b").reduced(num_layers=5)
    gen = torch.Generator().manual_seed(8)
    params = M.init_params(gen, cfg, "cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (B, 64), generator=gen)}
    a, ca = M.prefill(params, toks, cfg, use_pallas=True)
    b, cb = M.prefill(params, toks, cfg)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ca["mamba"]["state"], cb["mamba"]["state"],
                               rtol=1e-5, atol=1e-6)


def test_prefill_of_a_ragged_prompt_raises():
    """S not a multiple of the chunk raises, as the reference asserts; the
    prompt is not padded."""
    cfg = get_arch("zamba2-7b").reduced()
    params = M.init_params(torch.Generator().manual_seed(9), cfg, "cpu")
    toks = {"tokens": torch.zeros((1, cfg.ssm_chunk + 8), dtype=torch.long)}
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            M.prefill(params, toks, cfg, use_pallas=use_pallas)


def test_serve_cli_zamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--arch", "zamba2-7b"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve] OK" in r.stdout and "[serve] prefill 4x64" in r.stdout


def test_serve_driver_zamba2_returns_its_tokens():
    res = serve.run(["--device", "cpu", "--arch", "zamba2-7b", "--batch", "2",
                     "--prompt-len", "32", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["prefill_logits"].shape == (2, 32, res["cfg"].vocab_size)
    assert res["cfg"].family == "hybrid"

