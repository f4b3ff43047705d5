"""LM training through the port's DWFL round against the reference on the
CPU, at reduced size: the token data (``lm_dataset`` and ``LMBatcher``
bitwise, ``LMStore`` bitwise on replayed window starts, its own starts in
range and uniform), one worker-tree round and one flat-buffer round of
reduced olmo-1b (N = 3) from the replayed batch, seed and normals, the
chunked trajectory bitwise the per-round loop, and the optimizers. The
CLI for the LMs: ``test_torch_lm_cli.py``; each family's loss and
gradients, the per-worker losses and the eval: ``test_torch_lm_loss.py``.

Tolerances: a round's parameters within 1e-5 of their largest magnitude
(the two packages take the same batch, gradients and noise and differ by
float32 rounding in the forward, the backward and the mix; measured on the
CPU at 1.5e-8 tree and 1.2e-8 flat, relative); the optimizers' updates at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.data import device as ref_device
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.optim import optimizers as ref_optim
from repro_torch import optim
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_worker_params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import LMBatcher, LMStore, lm_dataset, store_from_batcher
from repro_torch.kernels.dp_mix import ops
from test_torch_protocol import ref_normals

N, B, S = 3, 2, 32
ROUND_TOL = 1e-5
NOISY = dict(n_workers=N, gamma=0.01, eta=0.4, clip=1.0, target_epsilon=0.0,
             sigma=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _olmo():
    return ref_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()


def _tokens(vocab, n=20_000, seed=3):
    return lm_dataset(n, vocab, seed=seed)


# -- data ---------------------------------------------------------------------


def test_lm_dataset_and_batcher_are_bitwise_the_reference():
    ours, ref = lm_dataset(30_000, 512, seed=5), \
        ref_synthetic.lm_dataset(30_000, 512, seed=5)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    a = LMBatcher(ours, 3, 4, 16, seed=7)
    b = ref_pipeline.LMBatcher(ref, 3, 4, 16, seed=7)
    for _ in range(3):
        np.testing.assert_array_equal(a.next()["tokens"], b.next()["tokens"])


def test_lm_store_samples_the_reference_windows_from_replayed_starts():
    toks = _tokens(512)
    rstore = ref_device.LMStore.build(toks, N, B, S)
    store = store_from_batcher(LMBatcher(toks, N, B, S), "cpu")
    assert isinstance(store, LMStore) and store.span == rstore.span
    key = jax.random.PRNGKey(4)
    starts = np.asarray(jax.random.randint(key, (N, B), 0,
                                           rstore.span - S - 1))
    got = store.sample(torch.from_numpy(starts))["tokens"]
    np.testing.assert_array_equal(got.numpy(), rstore.sample(key)["tokens"])
    # the fleet: replicate r's batch from split(key)[r]'s starts
    R = 2
    fstarts = np.stack([np.asarray(jax.random.randint(
        k, (N, B), 0, rstore.span - S - 1))
        for k in jax.random.split(key, R)])
    got = store.sample(torch.from_numpy(fstarts))["tokens"]
    np.testing.assert_array_equal(got.numpy(),
                                  rstore.sample_fleet(key, R)["tokens"])


def test_lm_store_starts_are_in_range_and_uniform():
    store = LMStore.build(_tokens(512, n=3 * 1000), N, 4, S, "cpu")
    high = store.span - S - 1
    gen = torch.Generator().manual_seed(1)
    s = store.starts(gen, (2000,))
    assert s.shape == (2000, N, 4)
    assert int(s.min()) >= 0 and int(s.max()) == high - 1
    # chi-square over 16 equal bins: 15 degrees of freedom, p = 0.001 at 37.7
    counts = np.bincount((s.numpy().reshape(-1) * 16) // high, minlength=16)
    expect = s.numel() / 16
    assert ((counts - expect) ** 2 / expect).sum() < 37.7
    # a fleet draw takes the values a single draw would at R = 1
    one = store.draw(torch.Generator().manual_seed(2))["tokens"]
    fleet = store.draw_fleet(torch.Generator().manual_seed(2), 1)["tokens"]
    torch.testing.assert_close(fleet[0], one, rtol=0, atol=0)
    assert one.shape == (N, 4, S)


# -- one round against the reference -------------------------------------------


def _ref_round_operands(seed=0):
    rcfg, cfg = _olmo()
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    flat, tree, spec = lm_worker_params_from_jax(
        jax.tree_util.tree_map(np.asarray, wp), "cpu")
    toks = _tokens(rcfg.vocab_size)
    rstore = ref_device.LMStore.build(toks, N, B, S)
    store = LMStore.build(toks, N, B, S, "cpu")
    k_data = jax.random.PRNGKey(21)
    starts = np.asarray(jax.random.randint(k_data, (N, B), 0,
                                           rstore.span - S - 1))
    return (rcfg, cfg, wp, flat, tree, spec, rstore.sample(k_data),
            store.sample(torch.from_numpy(starts)))


def _close_params(got: np.ndarray, want: np.ndarray) -> float:
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err < ROUND_TOL, err
    return err


def test_lm_worker_params_convert_in_the_reference_ravel_order():
    _, _, wp, flat, tree, spec, _, _ = _ref_round_operands()
    rflat = np.asarray(RX.FlatSpec(wp).flatten(wp))
    np.testing.assert_array_equal(flat.numpy(), rflat)
    assert spec.d == 1_441_792
    leaves, _ = X.tree_flatten(tree)
    assert all(l.is_contiguous() and l.shape[0] == N for l in leaves)
    # one copy a worker: writing worker 0 leaves worker 1 as it was
    leaves[0][0].add_(1.0)
    assert not torch.equal(leaves[0][0], leaves[0][1])


def test_one_tree_round_matches_reference():
    """use_pallas on the port's side: the card's path (one
    sgd_update_leaves launch), its plain version here."""
    rcfg, cfg, wp, _, tree, _, rb, tb = _ref_round_operands()
    proto = dict(NOISY, scheme="dwfl")
    rstep = jax.jit(RP.make_train_step(rcfg, RP.ProtocolConfig(**proto)))
    step = P.make_train_step(cfg, P.ProtocolConfig(**proto, use_pallas=True),
                             "cpu")
    key = jax.random.PRNGKey(11)
    rout, rm = rstep(wp, rb, key)
    out, m = step(tree, tb, None, normals=ref_normals("dwfl", wp, key))
    _close_params(X.flatten_worker_tree(out).numpy(),
                  np.asarray(RX.FlatSpec(rout).flatten(rout)))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)


def test_one_flat_round_matches_reference():
    rcfg, cfg, wp, flat, _, spec, rb, tb = _ref_round_operands(1)
    rspec = RX.FlatSpec(wp)
    rstep = jax.jit(RP.make_flat_train_step(
        rcfg, RP.ProtocolConfig(**NOISY), rspec.unravel_row))
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**NOISY), spec, "cpu")
    key = jax.random.PRNGKey(12)
    rout, rm = rstep(rspec.flatten(wp), rb, key)
    seed = ops.seed_from_key(np.asarray(jax.random.split(key, 3)[0]))
    out, m = step(flat, tb, seed)
    _close_params(out.numpy(), np.asarray(rout))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)


def test_chunked_trajectory_is_bitwise_the_per_round_loop():
    _, cfg = _olmo()
    proto = P.ProtocolConfig(**dict(NOISY, use_pallas=True))
    wp = P.init_worker_params(torch.Generator().manual_seed(3), cfg, N, "cpu")
    store = LMStore.build(_tokens(cfg.vocab_size), N, B, S, "cpu")
    body = TJ.make_round_body(cfg, proto, store, device="cpu")
    finals = []
    for runner, cuts in ((TJ.run_per_round, (4,)), (TJ.run_chunk, (4,)),
                         (TJ.run_chunk, (1, 3))):
        carry = TJ.TrajCarry(torch.Generator().manual_seed(9), wp)
        losses = []
        for k in cuts:
            carry, out = runner(body, carry, k)
            losses.append(out["metrics"]["loss"])
        assert torch.cat(losses).shape == (4,)
        assert torch.isfinite(torch.cat(losses)).all()
        finals.append(X.flatten_worker_tree(carry.params))
    for f in finals[1:]:
        torch.testing.assert_close(f, finals[0], rtol=0, atol=0)


# -- the optimizers --------------------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizer_update_matches_reference(name):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        for _ in range(3)]
    make = {"sgd": lambda m: m.sgd(0.1), "momentum": lambda m: m.momentum(0.1),
            "adam": lambda m: m.adam(0.01)}[name]
    ropt, opt = make(ref_optim), make(optim)
    to_t = lambda t: X.tree_map(torch.from_numpy, t)
    rp, p = jax.tree_util.tree_map(jnp.asarray, tree), to_t(tree)
    rs, s = ropt.init(rp), opt.init(p)
    for g in grads:
        rp, rs = ropt.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        p, s = opt.update(to_t(g), s, p)
    for got, want in zip(X.tree_flatten(p)[0], jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
