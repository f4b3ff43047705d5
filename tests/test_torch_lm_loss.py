"""Each LM family's training loss and its gradients through the port
against the reference's ``jax.value_and_grad(loss_fn)`` on the CPU at
reduced size, the per-worker losses of worker-stacked parameters against
the reference's vmap, and the eval (C6) against the reference's
``make_eval_fn``.

Batches are those of ``tests/test_archs_smoke.py::_batch_for``: tokens for
the text families, embeds and labels for qwen2-vl-2b (and tokens alone,
what the CLI's token stream gives it), embeds and tokens for
whisper-medium. Tolerances: the loss at rtol 1e-5; each leaf's gradient
within 1e-4 of that leaf's largest |g| (measured at most 1.7e-5, on
zamba2-7b; 2-3e-6 on the others); the eval at rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.core import protocol as RP
from repro.models import model as RM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_worker_params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.models import model as M
from _torch_parity import ref_params

N = 3
CASES = ["olmo-1b", "gemma-2b", "qwen2-vl-2b", "qwen2-vl-2b:tokens",
         "deepseek-moe-16b", "zamba2-7b", "xlstm-1.3b", "whisper-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_for(cfg, key, B=2, S=32, tokens_only=False, lead=()):
    """tests/test_archs_smoke.py::_batch_for, with leading axes ``lead``
    (the workers')."""
    if cfg.is_encoder_decoder:
        return {"embeds": jax.random.normal(
                    key, lead + (B, cfg.encoder_seq_len, cfg.d_model)) * 0.02,
                "tokens": jax.random.randint(key, lead + (B, S), 0,
                                             cfg.vocab_size)}
    if cfg.embedding_inputs and not tokens_only:
        return {"embeds": jax.random.normal(key, lead + (B, S, cfg.d_model))
                * 0.02,
                "labels": jax.random.randint(key, lead + (B, S), 0,
                                             cfg.vocab_size)}
    return {"tokens": jax.random.randint(key, lead + (B, S), 0,
                                         cfg.vocab_size)}


def _case(case):
    arch, _, mode = case.partition(":")
    return ref_arch(arch).reduced(), get_arch(arch).reduced(), mode == "tokens"


def _torch_batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


@pytest.mark.parametrize("case", CASES)
def test_family_loss_and_gradients_match_reference(case):
    rcfg, cfg, tokens_only = _case(case)
    jp, tp = ref_params(rcfg, 0)
    jb = _batch_for(rcfg, jax.random.PRNGKey(1), tokens_only=tokens_only)
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg)))(jp, jb)
    leaves, structure = X.tree_flatten(tp)
    ps = [l.requires_grad_(True) for l in leaves]
    loss = M.loss_fn(X.tree_unflatten(structure, ps), _torch_batch(jb), cfg)
    gs = torch.autograd.grad(loss, ps)
    assert float(loss.detach()) == pytest.approx(float(rl), rel=1e-5)
    want = jax.tree_util.tree_leaves(rg)
    assert len(gs) == len(want)
    for g, w in zip(gs, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_worker_losses_match_the_reference_vmap(arch):
    """Worker i's loss is a function of its own parameters and batch: the
    MoE's capacity and aux loss are per worker's tokens, so folding the
    workers into the batch axis would differ."""
    rcfg, cfg, _ = _case(arch)
    # each worker its own parameters: the init scaled by 1 + i/10
    wp = jax.tree_util.tree_map(
        lambda l: np.stack([np.asarray(l) * (1 + i / 10) for i in range(N)]),
        ref_params(rcfg, 0)[0])
    jb = _batch_for(rcfg, jax.random.PRNGKey(3), lead=(N,))
    want = jax.jit(jax.vmap(lambda p, b: RM.loss_fn(p, b, rcfg)))(wp, jb)
    _, tree, _ = lm_worker_params_from_jax(wp, "cpu")
    got = M.worker_losses(tree, _torch_batch(jb), cfg)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert len(set(np.asarray(want).tolist())) == N


@pytest.mark.parametrize("case", ["olmo-1b", "qwen2-vl-2b",
                                  "deepseek-moe-16b"])
def test_eval_fn_matches_reference_on_lm_batches(case):
    """C6: the LM loss (the MoE's with its aux term) and the next-token
    accuracy on tokens, the accuracy against labels where the batch
    carries them."""
    rcfg, cfg, _ = _case(case)
    wp = RP.init_worker_params(jax.random.PRNGKey(4), rcfg, N)
    jb = _batch_for(rcfg, jax.random.PRNGKey(5), lead=(N,))
    rl, ra = jax.jit(RP.make_eval_fn(rcfg))(wp, jb)
    _, tree, _ = lm_worker_params_from_jax(
        jax.tree_util.tree_map(np.asarray, wp), "cpu")
    el, ea = P.make_eval_fn(cfg)(tree, _torch_batch(jb))
    assert float(el) == pytest.approx(float(rl), rel=1e-5)
    assert float(ea) == pytest.approx(float(ra), abs=1e-6)
    assert np.isfinite(float(el)) and np.isfinite(float(ea))
