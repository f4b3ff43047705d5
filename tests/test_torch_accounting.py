"""The port's privacy ledger (``repro_torch.core.accounting``,
``core.privacy``) against the reference's on the CPU.

Host math is float64 numpy in both packages, the same operations in the
same order: the tests require equality, or rtol 1e-12 where a bisection
or a sum may end one rounding apart. The functions that run on tensors
(``epsilon_dwfl_traced``, ``sigma_for_epsilon_traced``,
``rdp_dwfl_traced``, ``sigma_for_rho_traced``, ``epsilon_trajectory``)
compute in float32 from the reference's realized channel and W, in sum
orders that may differ: rtol 1e-6. The static ``epsilon_report`` with a
horizon T, with and without sampled participation, and the total-budget
calibration of ``ProtocolConfig.channel()`` are the reference's, key for
key.
"""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as RA
from repro.core import privacy as rpriv
from repro.core import protocol as RP
from repro.core.channel import ChannelConfig as RefChannelConfig
from repro.net import geometry as rgeometry
from repro.net import state as rstate
from repro_torch.core import accounting as A
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.core.channel import ChannelConfig
from test_torch_net import port_chan, ref_round, t

RTOL = 1e-6


def _chans(N=10, seed=3, sigma_m=0.3):
    cfg = dict(n_workers=N, p_dbm=40.0, sigma=1.0, sigma_m=sigma_m, seed=seed)
    return ChannelConfig(**cfg).realize(), RefChannelConfig(**cfg).realize()


def _equal(got, want, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k], rtol)
    elif rtol:
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


def test_order_grid_and_gaussian_curve_equal_reference():
    assert A.ORDER_GRID == RA.ORDER_GRID and A.N_ORDERS == RA.N_ORDERS
    for sens, sig, eps in ((1.0, 2.0, 0.5), (2.0, 0.7, 4.0), (1.0, 0.2, 10.0)):
        assert A.gaussian_delta(sens, sig, eps) == \
            RA.gaussian_delta(sens, sig, eps)
        assert A.gaussian_epsilon(sens, sig, 1e-5) == \
            RA.gaussian_epsilon(sens, sig, 1e-5)
    for eps in (0.3, 1.0, 4.0, 10.0):
        assert privacy.gaussian_mechanism_sigma(2.0, eps, 1e-5) == \
            rpriv.gaussian_mechanism_sigma(2.0, eps, 1e-5)
    with pytest.raises(ValueError):
        privacy.gaussian_mechanism_sigma(1.0, 0.0, 1e-5)


def test_rdp_host_functions_equal_reference():
    rng = np.random.default_rng(0)
    for rho in (1e-4, 0.05, 0.7):
        for q in (0.1, 0.5, 1.0):
            _equal(A.rdp_subsampled_gaussian(rho, q),
                   RA.rdp_subsampled_gaussian(rho, q))
    ledger = rng.uniform(0, 2, (3, A.N_ORDERS))
    for delta in (1e-5, np.asarray([1e-5, 1e-6, 1e-3])):
        _equal(A.rdp_to_epsilon(ledger, delta), RA.rdp_to_epsilon(ledger,
                                                                  delta))
    assert A.rdp_to_epsilon(np.zeros(A.N_ORDERS), 1e-5) == \
        RA.rdp_to_epsilon(np.zeros(A.N_ORDERS), 1e-5)
    assert A.rho_from_epsilon(0.5, 1e-5) == RA.rho_from_epsilon(0.5, 1e-5)
    for T in (1, 64, 4096):
        assert A.split_delta(1e-5, T) == RA.split_delta(1e-5, T)
    for bad in ((0.0, 10), (1.5, 10), (1e-5, 0), (5e-324, 10 ** 9)):
        with pytest.raises(ValueError):
            A.split_delta(*bad)
    assert A.rescale_epsilon_delta(0.7, 1e-5, 1e-7) == \
        RA.rescale_epsilon_delta(0.7, 1e-5, 1e-7)
    for eps_total in (1.0, 8.0):
        assert A.rho_total_for_epsilon(eps_total, 1e-5) == \
            RA.rho_total_for_epsilon(eps_total, 1e-5)
        assert A.epsilon_round_for_total_advanced(eps_total, 1e-5, 50) == \
            RA.epsilon_round_for_total_advanced(eps_total, 1e-5, 50)


@pytest.mark.parametrize("shape", [(200,), (3, 40)])
def test_compose_trajectory_equals_reference(shape):
    eps = np.random.default_rng(1).uniform(0.05, 0.3, size=shape)
    _equal(A.compose_trajectory(eps, 1e-5), RA.compose_trajectory(eps, 1e-5),
           rtol=1e-12)
    _equal(A.compose_trajectory(eps, 1e-5, delta_ref=1e-6),
           RA.compose_trajectory(eps, 1e-5, delta_ref=1e-6), rtol=1e-12)


def test_compositions_equal_reference_and_saturate():
    rng = np.random.default_rng(2)
    eps = rng.uniform(0.05, 0.5, 37)
    assert privacy.compose_heterogeneous(eps, 1e-6) == \
        rpriv.compose_heterogeneous(eps, 1e-6)
    _equal(privacy.compose_heterogeneous_batched(eps.reshape(1, -1), 1e-6),
           rpriv.compose_heterogeneous_batched(eps.reshape(1, -1), 1e-6))
    for args in ((0.3, 1e-6, 50), (0.3, 1e-6, 50, 1e-7)):
        assert privacy.compose_advanced(*args) == rpriv.compose_advanced(*args)
    assert privacy.compose_naive(0.3, 1e-6, 50) == \
        rpriv.compose_naive(0.3, 1e-6, 50)
    for q in (0.1, 0.9):
        assert privacy.epsilon_sampled(0.8, 1e-5, q) == \
            rpriv.epsilon_sampled(0.8, 1e-5, q)
    assert privacy.EPS_SATURATION == rpriv.EPS_SATURATION
    with pytest.warns(RuntimeWarning, match="saturated"):
        e, _ = privacy.compose_advanced(800.0, 1e-6, 10)
    assert e == privacy.EPS_SATURATION
    with pytest.warns(RuntimeWarning, match="saturated"):
        eb, _ = privacy.compose_heterogeneous_batched(
            np.asarray([[0.1, 800.0], [0.1, 0.2]]), 1e-6)
    assert eb[0] == privacy.EPS_SATURATION and eb[1] < 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        privacy.compose_advanced(0.3, 1e-6, 50)


@pytest.mark.parametrize("accountant", ["composition", "rdp", "min"])
def test_compose_from_moments_equals_reference(accountant):
    rng = np.random.default_rng(3)
    e = rng.uniform(0.05, 0.4, (2, 30))
    m = np.concatenate([np.stack([e.sum(-1), (e ** 2).sum(-1),
                                  (e * np.expm1(e)).sum(-1),
                                  np.full(2, 30.0)], -1),
                        (e.sum(-1, keepdims=True) ** 2 / 4.0)
                        * np.asarray(A.ORDER_GRID)], -1)
    _equal(privacy.compose_from_moments(m, 1e-6, accountant=accountant),
           rpriv.compose_from_moments(m, 1e-6, accountant=accountant))
    if accountant == "composition":
        _equal(privacy.compose_from_moments(m[..., :4], 1e-6),
               rpriv.compose_from_moments(m[..., :4], 1e-6))
    else:
        with pytest.raises(ValueError):
            privacy.compose_from_moments(m[..., :4], 1e-6,
                                         accountant=accountant)


@pytest.mark.parametrize("accountant", ["rdp", "composition"])
@pytest.mark.parametrize("topology", ["complete", "ring"])
def test_sigma_for_total_epsilon_equals_reference(accountant, topology):
    chan, rchan = _chans(sigma_m=0.1)
    W = None if topology == "complete" else P.ProtocolConfig(
        n_workers=10, topology="ring").mixing_matrix()
    kw = dict(gamma=0.05, g_max=1.0, delta_total=1e-5, T=512,
              accountant=accountant, W=W)
    assert A.sigma_for_total_epsilon(10.0, chan=chan, **kw) == \
        RA.sigma_for_total_epsilon(10.0, chan=rchan, **kw)
    assert A._worst_masking_sum(chan, W) == RA._worst_masking_sum(rchan, W)
    with pytest.raises(ValueError):
        A.sigma_for_total_epsilon(10.0, chan=chan,
                                  **dict(kw, accountant="naive"))


@pytest.mark.parametrize("acct", ["rdp", "composition"])
def test_protocol_total_budget_calibration_equals_reference(acct):
    kw = dict(scheme="dwfl", n_workers=8, gamma=0.05, clip=1.0, sigma_m=0.3,
              p_dbm=40.0, target_epsilon=0.0, accountant=acct,
              target_total_epsilon=8.0, horizon=256)
    assert P.ProtocolConfig(**kw).channel().cfg.sigma == \
        RP.ProtocolConfig(**kw).channel().cfg.sigma
    for bad in (dict(target_epsilon=1.0), dict(horizon=0),
                dict(scheme="orthogonal")):
        with pytest.raises(ValueError):
            P.ProtocolConfig(**dict(kw, **bad)).channel()


def _graph():
    """A five-worker cycle plus an isolated sixth, as a Metropolis W."""
    adj = np.zeros((6, 6), np.float32)
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]:
        adj[i, j] = adj[j, i] = 1.0
    return np.asarray(rgeometry.metropolis_weights(jnp.asarray(adj)))


@pytest.mark.parametrize("with_W", [False, True])
def test_traced_budgets_and_calibration_equal_reference(with_W):
    """Theorem 4.1, the per-round calibration and the RDP rate on a
    traced channel: epsilon 0 for a receiver that hears nobody, and more
    noise for fewer maskers."""
    _, rchan = _chans(N=6, seed=1, sigma_m=0.5)
    rtr = rstate.TracedChannelState.from_static(rchan)
    tr = port_chan(rtr)
    rW = _graph() if with_W else None
    W = None if rW is None else t(rW)
    np.testing.assert_allclose(
        privacy.epsilon_dwfl_traced(0.05, 1.0, tr, 1e-5, W),
        rpriv.epsilon_dwfl_traced(0.05, 1.0, rtr, 1e-5, rW), rtol=RTOL)
    for eps in (0.3, 4.0):
        np.testing.assert_allclose(
            privacy.sigma_for_epsilon_traced(eps, 0.05, 1.0, tr, 1e-5, W),
            rpriv.sigma_for_epsilon_traced(eps, 0.05, 1.0, rtr, 1e-5, rW),
            rtol=RTOL)
    np.testing.assert_allclose(A.rdp_dwfl_traced(0.05, 1.0, tr, W),
                               RA.rdp_dwfl_traced(0.05, 1.0, rtr, rW),
                               rtol=RTOL)
    np.testing.assert_allclose(A.sigma_for_rho_traced(1e-3, 0.05, 1.0, tr, W),
                               RA.sigma_for_rho_traced(1e-3, 0.05, 1.0, rtr,
                                                       rW), rtol=RTOL)
    if with_W:
        assert float(privacy.epsilon_dwfl_traced(0.05, 1.0, tr, 1e-5,
                                                 W)[5]) == 0.0
        assert float(privacy.sigma_for_epsilon_traced(0.3, 0.05, 1.0, tr,
                                                      1e-5, W)) > \
            float(privacy.sigma_for_epsilon_traced(0.3, 0.05, 1.0, tr, 1e-5))


def test_epsilon_trajectory_batched_equals_reference():
    """[T, N] budgets of a realized trajectory in one batched evaluation,
    against the reference's vmap, with and without the rounds' Ws."""
    rsim, rst, _, _, _ = ref_round("vehicular", 8, 4, p_dbm=65.0,
                                   target_epsilon=0.7)
    rchans, _, rWs = rsim.trajectory(jax.random.PRNGKey(5), 12, rst)
    chans = port_chan(rchans)
    for Ws, rWs_ in ((None, None), (t(rWs), rWs)):
        got = privacy.epsilon_trajectory(0.05, 1.0, chans, 1e-5, Ws)
        want = rpriv.epsilon_trajectory(0.05, 1.0, rchans, 1e-5, rWs_)
        assert got.shape == (12, 8)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    rdp = A.rdp_dwfl_traced(0.05, 1.0, chans, t(rWs))
    assert rdp.shape == (12, A.N_ORDERS)
    np.testing.assert_allclose(
        rdp, jax.vmap(lambda c, w: RA.rdp_dwfl_traced(0.05, 1.0, c, w))(
            rchans, rWs), rtol=RTOL)


@pytest.mark.parametrize("participation", [1.0, 0.5])
@pytest.mark.parametrize("T", [None, 128])
def test_static_epsilon_report_equals_reference(participation, T):
    kw = dict(scheme="dwfl", n_workers=10, gamma=0.05, clip=1.0, sigma=1.0,
              sigma_m=1.0, target_epsilon=0.0, participation=participation,
              accountant="rdp")
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    rep = P.epsilon_report(proto, proto.channel(), T=T)
    rrep = RP.epsilon_report(rproto, rproto.channel(), T=T)
    _equal(rep, rrep)
    if T:
        assert rep["epsilon_T_rdp"] < rep["epsilon_T_advanced_split"]
    if participation < 1.0:
        assert rep["participation_effective"] == pytest.approx(
            0.5 + 0.5 * 2 / 10)
