"""The port's channel, mix plans and privacy calibration against the
reference: ``realize``, ``plan_complete``/``plan_gossip``, the Thm 4.1 and
Remark 4.1 budgets and ``sigma_for_epsilon`` (both sides of the analytic
epsilon > 1 switch) equal."""
import numpy as np
import pytest
import torch

from repro.core import accounting as ref_acc
from repro.core import exchange as RX
from repro.core import privacy as ref_priv
from repro.core import protocol as RP
from repro.core.channel import ChannelConfig as RefChannelConfig
from repro_torch.core import accounting, exchange as X, privacy
from repro_torch.core import protocol as P
from repro_torch.core.channel import ChannelConfig

CASES = [dict(n_workers=10, p_dbm=60.0, seed=0),
         dict(n_workers=6, p_dbm=30.0, sigma=0.7, sigma_m=0.4, seed=3),
         dict(n_workers=5, fading="unit", noise_policy="equal", seed=1)]


@pytest.mark.parametrize("kw", CASES)
def test_realize_equal(kw):
    a, b = ChannelConfig(**kw).realize(), RefChannelConfig(**kw).realize()
    for f in ("h", "P", "alpha", "beta"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.c == b.c
    np.testing.assert_array_equal(a.noise_scale, b.noise_scale)
    np.testing.assert_array_equal(a.aggregate_noise_std, b.aggregate_noise_std)


@pytest.mark.parametrize("kw", CASES)
def test_plans_equal(kw):
    chan, rchan = ChannelConfig(**kw).realize(), RefChannelConfig(**kw).realize()
    for port, ref in ((X.plan_complete(None, chan, "cpu"),
                       RX.plan_complete(None, rchan)),
                      (X.plan_gossip(None, chan, "cpu"),
                       RX.plan_gossip(None, rchan))):
        assert port.noisy == ref.noisy
        for f in ("W", "c", "amp", "sigma_m", "m_scale"):
            np.testing.assert_array_equal(getattr(port, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert port.self_scale is None and ref.self_scale is None
        assert port.listen is None and ref.listen is None


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("eps", [0.3, 1.0, 4.0])
def test_budgets_and_calibration_equal(kw, eps):
    chan, rchan = ChannelConfig(**kw).realize(), RefChannelConfig(**kw).realize()
    args = (0.01, 1.0)
    np.testing.assert_array_equal(privacy.epsilon_dwfl(*args, chan, 1e-5),
                                  ref_priv.epsilon_dwfl(*args, rchan, 1e-5))
    np.testing.assert_array_equal(
        privacy.epsilon_orthogonal(*args, chan, 1e-5),
        ref_priv.epsilon_orthogonal(*args, rchan, 1e-5))
    assert privacy.l2_sensitivity(*args, chan) == \
        ref_priv.l2_sensitivity(*args, rchan)
    assert privacy.sigma_for_epsilon(eps, *args, chan, 1e-5) == \
        ref_priv.sigma_for_epsilon(eps, *args, rchan, 1e-5)
    assert accounting.noise_multiplier(eps, 1e-5) == \
        ref_acc.noise_multiplier(eps, 1e-5)
    assert accounting.CLASSIC_EPS_MAX == ref_acc.CLASSIC_EPS_MAX


def test_protocol_channel_and_report_equal():
    kw = dict(n_workers=10, gamma=0.01, eta=0.4, target_epsilon=1.0)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    chan, rchan = proto.channel(), rproto.channel()
    assert chan.cfg.sigma == rchan.cfg.sigma
    rep, rrep = P.epsilon_report(proto, chan), RP.epsilon_report(rproto, rchan)
    for k in ("epsilon_worst", "epsilon_orthogonal_worst", "sigma"):
        assert rep[k] == rrep[k]
    np.testing.assert_array_equal(rep["epsilon_per_worker"],
                                  rrep["epsilon_per_worker"])


def test_clip_gradient_rows():
    g = torch.tensor([[3.0, 4.0], [0.3, 0.4], [float("nan"), 1.0],
                      [float("inf"), 0.0]])
    c, n = privacy.clip_gradient_tree(g, 1.0)
    torch.testing.assert_close(c[0], torch.tensor([0.6, 0.8]))
    torch.testing.assert_close(c[1], torch.tensor([0.3, 0.4]))
    assert float(c[2:].abs().max()) == 0.0
    torch.testing.assert_close(n, torch.tensor([5.0, 0.5, 0.0, 0.0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_sum_squares_is_one_reduction_on_the_cpu(dtype):
    """On the CPU the clip's per-row sum of squares is the one float32
    reduction it always was (bitwise), for any row block."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(10, 5000)).astype(np.float32)).to(dtype)
    want = torch.sum(x.float() ** 2, dim=1)
    assert torch.equal(privacy.row_sum_squares(x), want)
    assert torch.equal(privacy.row_sum_squares(x[5:]), want[5:])
