"""The port's bfloat16 prefill on the CPU against the reference's, for
gemma-2b and olmo-1b at ``reduced()`` size: the reference's parameters,
drawn in float32 and cast to bfloat16 in each package (both round to
nearest even), with ``param_dtype`` and ``compute_dtype`` bfloat16 as
the reference's pod dry-run sets them (``DRYRUN_OVERRIDES``). The port
runs with ``use_pallas=True`` (flash_attention's plain version, float32
inside, as the kernel) and without; the reference without.

Tolerance: 2^-5 of the logits' largest magnitude, four bfloat16 steps.
bfloat16 keeps 8 significant bits and the two frameworks round at other
places (XLA fuses and keeps some intermediates in float32; torch rounds
each operator's output; the kernel's attention keeps its scores and
probabilities in float32, the plain path rounds them), so the logits
differ by a few steps of their own rounding: measured up to 2^-6 of
their scale over three seeds of each arch, and the reference's own
bfloat16 prefill is 2^-6 from its float32 one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as M

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
TOL = 2.0 ** -5


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_prefill_matches_reference(arch, seed):
    rcfg32 = ref_get_arch(arch).reduced()
    rcfg, cfg = rcfg32.replace(**BF16), get_arch(arch).reduced().replace(**BF16)
    jp32 = RM.init_params(jax.random.PRNGKey(seed), rcfg32)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp32)
    tp = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp32), "cpu"))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 40))
    want, _ = RM.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, rcfg)
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    for use_pallas in (True, False):
        got, cache = M.prefill(tp, {"tokens": torch.tensor(tokens)}, cfg,
                               use_pallas=use_pallas)
        assert got.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
        got = got.float().numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= TOL * max(1.0, scale)
