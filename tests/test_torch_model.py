"""The port's model and flat buffer against the reference: FlatSpec ravel
bitwise equal to ``make_flat_spec(...).flatten``, ``params_from_jax``
round trips, and the per-worker loss and clipped gradients equal to
``protocol._make_flat_local_pass`` at float32 tolerance, non-finite guard
included, and the eval of the classifier and of an LM."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.models import model as M

N, B, HIDDEN = 3, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(seed=0):
    cfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), cfg, N)
    # make the workers differ, as they do after a few rounds
    return cfg, jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.arange(N, dtype=a.dtype).reshape(
            (N,) + (1,) * (a.ndim - 1)), wp)


def _batch(seed=0, poison=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, B, 3072)).astype(np.float32)
    if poison:
        x[1, 0, 0] = np.inf
    y = rng.integers(0, 10, (N, B)).astype(np.int32)
    return x, y


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_flat_spec_ravel_is_bitwise_the_reference():
    _, wp = _ref_params()
    want = np.asarray(RX.FlatSpec(wp).flatten(wp))
    flat, layers, spec = params_from_jax(_np_tree(wp), device="cpu")
    np.testing.assert_array_equal(flat.numpy(), want)
    assert spec.d == want.shape[1] == 3072 * 16 + 16 + 16 * 16 + 16 + 16 * 10 + 10
    # the same spec on the port's own init ravels b before w per layer
    gen = torch.Generator().manual_seed(0)
    own = P.init_worker_params(gen, dataclasses.replace(DWFL_PAPER,
                                                        d_model=HIDDEN), N, "cpu")
    ospec = X.FlatSpec(own)
    oflat = ospec.flatten(own)
    torch.testing.assert_close(oflat[:, :16], own["layers"][0]["b"],
                               rtol=0, atol=0)
    torch.testing.assert_close(oflat[:, 16:16 + 3072 * 16],
                               own["layers"][0]["w"].reshape(N, -1),
                               rtol=0, atol=0)


def test_params_from_jax_round_trips():
    _, wp = _ref_params(1)
    tree = _np_tree(wp)
    flat, layers, spec = params_from_jax(tree, device="cpu")
    for lyr, ref in zip(layers["layers"], tree["layers"]):
        np.testing.assert_array_equal(lyr["w"].numpy(), ref["w"])
        np.testing.assert_array_equal(lyr["b"].numpy(), ref["b"])
    row = spec.unravel_row(flat[2])
    np.testing.assert_array_equal(row["layers"][1]["w"].numpy(),
                                  tree["layers"][1]["w"][2])
    # one unstacked tree, repeated over the workers
    one = jax.tree_util.tree_map(lambda a: a[0], tree)
    flat1, _, _ = params_from_jax(one, n_workers=N, device="cpu")
    np.testing.assert_array_equal(flat1.numpy()[1], flat.numpy()[0])
    # the init scale of dense_init: 1/sqrt(in_dim)
    gen = torch.Generator().manual_seed(0)
    w = M.init_params(gen, DWFL_PAPER, "cpu")["layers"][0]["w"]
    assert abs(float(w.std()) * np.sqrt(3072) - 1.0) < 0.01


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nonfinite"])
def test_loss_and_clipped_grads_match_reference(poison):
    cfg, wp = _ref_params(2)
    rspec = RX.FlatSpec(wp)
    rflat = rspec.flatten(wp)
    proto = RP.ProtocolConfig(n_workers=N, clip=0.5)
    local = jax.jit(RP._make_flat_local_pass(cfg, proto, rspec.unravel_row))
    x, y = _batch(3, poison)
    rl, rg, rn = local(rflat, {"x": jnp.asarray(x), "y": jnp.asarray(y)})

    flat, _, spec = params_from_jax(_np_tree(wp), device="cpu")
    pcfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    pproto = P.ProtocolConfig(n_workers=N, clip=0.5)
    losses, g, norms = P.make_flat_local_pass(pcfg, pproto, spec)(
        flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()})
    ok = np.isfinite(np.asarray(rl))
    np.testing.assert_array_equal(np.isfinite(losses.numpy()), ok)
    np.testing.assert_allclose(losses.numpy()[ok], np.asarray(rl)[ok],
                               rtol=1e-5)
    np.testing.assert_allclose(norms.numpy(), np.asarray(rn), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-4,
                               atol=1e-6)
    if poison:     # the poisoned worker's gradient is zeroed, norm 0
        assert float(norms[1]) == 0.0 and float(g[1].abs().max()) == 0.0
    assert float(norms.max()) > 0.5      # the clip was active
    np.testing.assert_allclose(g.norm(dim=1).numpy(),
                               np.minimum(norms.numpy(), 0.5), rtol=1e-5)


def test_eval_fn_matches_reference_and_nan_without_labels():
    """The classifier's eval and an LM's (C6: its loss and next-token
    accuracy, not NaN) against the reference's; NaN only for a batch with
    no labels at all (neither "y", "labels" nor "tokens")."""
    cfg, wp = _ref_params(4)
    x, y = _batch(5)
    rl, ra = RP.make_eval_fn(cfg)(wp, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
    flat, layers, _ = params_from_jax(_np_tree(wp), device="cpu")
    pcfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    ev = P.make_eval_fn(pcfg)
    el, ea = ev(layers, {"x": torch.from_numpy(x),
                         "y": torch.from_numpy(y).long()})
    np.testing.assert_allclose(float(el), float(rl), rtol=1e-5)
    assert float(ea) == pytest.approx(float(ra))
    nan_loss, nan_acc = ev(layers, {"x": torch.from_numpy(x)})
    assert np.isnan(float(nan_acc)) and np.isnan(float(nan_loss))

    from repro.configs.registry import get_arch as ref_arch
    from repro_torch.configs.registry import get_arch
    from repro_torch.convert import lm_worker_params_from_jax
    rcfg, lcfg = ref_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()
    lwp = RP.init_worker_params(jax.random.PRNGKey(6), rcfg, N)
    toks = jax.random.randint(jax.random.PRNGKey(7), (N, 2, 16), 0,
                              rcfg.vocab_size)
    rl, ra = jax.jit(RP.make_eval_fn(rcfg))(lwp, {"tokens": toks})
    _, tree, _ = lm_worker_params_from_jax(_np_tree(lwp), "cpu")
    lev = P.make_eval_fn(lcfg)
    el, ea = lev(tree, {"tokens": torch.from_numpy(np.array(toks))})
    np.testing.assert_allclose(float(el), float(rl), rtol=1e-5)
    assert float(ea) == pytest.approx(float(ra))
    assert np.isfinite(float(el)) and np.isfinite(float(ea))
    embeds = torch.zeros((N, 2, 16, lcfg.d_model))
    nan_loss, nan_acc = lev(tree, {"embeds": embeds})
    assert np.isnan(float(nan_acc)) and np.isnan(float(nan_loss))
