"""The dp_mix CUDA kernel against its plain PyTorch version on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. On a machine with a card and nvcc but no JAX
(tests/conftest.py imports JAX, so it is left out):
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py``.
Tolerance as in chip_smoke.py: both sum N float32 products in different
orders, so |kernel - plain| <= (N + 8) * 2^-23 * scale, scale = max|x| +
5.42 max|n/c| + 5.42 max|m_scale sigma_m|; a bfloat16 output may land one
bfloat16 step (2^-7 of its magnitude) further."""
import pytest
import torch

from repro_torch.core import exchange as X
from repro_torch.core.channel import ChannelConfig
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.parametrize("N,d", [(10, 5000), (3, 130), (64, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False])
def test_kernel_matches_plain(N, d, dtype, noisy):
    _need_card()
    chan = ChannelConfig(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4,
                         seed=N).realize()
    plan = (X.plan_complete if noisy else X.plan_gossip)(None, chan, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.2 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    seed, col0 = (torch.tensor([v], dtype=torch.int32, device="cuda")
                  for v in (77, 256))
    c = plan.c.reshape(())
    ones = torch.ones(N, device="cuda")
    args = (p, g, seed, col0, torch.stack([c, plan.sigma_m.reshape(())]),
            plan.amp, ones, plan.m_scale, ones, plan.W.contiguous())
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, counter_width=8192)
    before = ops.dp_mix_round.launches
    out = ops._launch(*args, **kw)
    assert ops.dp_mix_round.launches == before + 1
    ref = dp_mix_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == p.shape
    k32, r32 = out.float(), ref.float()
    x = p.float() - 0.05 * g.float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((plan.amp / c).abs().max()
                              + (plan.m_scale * plan.sigma_m).abs().max())
    allowed = (N + 8) * 2.0 ** -23 * scale
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
    assert bool(((k32 - r32).abs() <= allowed).all())


def test_wrapper_limits_on_the_card():
    _need_card()
    p = torch.zeros((65, 8), device="cuda")
    with pytest.raises(ValueError, match="N <= 64"):
        ops.dp_mix_round(p, p, 0, torch.eye(65), torch.ones(65), 1.0, 0.0,
                         gamma=0.1, eta=0.5)
    with pytest.raises(TypeError):
        q = torch.zeros((4, 8), device="cuda", dtype=torch.float64)
        ops.dp_mix_round(q, q, 0, torch.eye(4), torch.ones(4), 1.0, 0.0,
                         gamma=0.1, eta=0.5)
