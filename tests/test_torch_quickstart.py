"""The reference's quickstart run (examples/quickstart.py settings: N = 10,
input 256, hidden 64, gamma 0.02, eta 0.4, p_dbm 75, eps = 1 per round)
for 301 rounds in both packages, the port replaying the reference's
per-round data uniforms and noise seeds from the same initial buffer.

The port must land in the healthy band the reference reaches (eval
accuracy >= 0.25 by round 300) with the same accuracy at every eval point.
Measured on the CPU: accuracies 0.0750, 0.1625, 0.1969, 0.2656 at rounds
0, 100, 200, 300 in both packages, buffer drift 1.5e-6 at round 300;
the bounds allow two eval samples of 1,280 to flip and 10x the drift."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.data import device as ref_device
import repro.models.mlp as ref_mlp
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import protocol as P
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)
from repro_torch.kernels.dp_mix import ops

N, B, HIDDEN, DIM = 10, 32, 64, 256
KW = dict(n_workers=N, gamma=0.02, eta=0.4, clip=1.0, p_dbm=75.0,
          target_epsilon=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_replay_reaches_the_reference_accuracy():
    x, y = classification_dataset(6000, input_dim=DIM, seed=0)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=0)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    params = ref_mlp.init(jax.random.PRNGKey(0), rcfg, input_dim=DIM)
    wp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), params)
    rspec = RX.FlatSpec(wp)
    rflat = rspec.flatten(wp)
    rstep = jax.jit(RP.make_flat_train_step(rcfg, RP.ProtocolConfig(**KW),
                                            rspec.unravel_row))
    revaluate = jax.jit(RP.make_eval_fn(rcfg))
    rstore = ref_device.ClassificationStore.build(x, y, parts, B)

    cfg = DWFL_PAPER.replace(d_model=HIDDEN)
    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**KW), spec, "cpu")
    evaluate = P.make_eval_fn(cfg)
    store = ClassificationStore.build(x, y, parts, B, device="cpu")
    ev = FederatedBatcher(x, y, parts, B).full(128)
    rev = {k: jnp.asarray(v) for k, v in ev.items()}
    pev = {k: torch.as_tensor(v) for k, v in ev.items()}

    key = jax.random.PRNGKey(1)
    accs = []
    for t in range(301):
        key, sk = jax.random.split(key)
        k_data, k_step = jax.random.split(sk)
        rflat, _ = rstep(rflat, rstore.sample(k_data), k_step)
        u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
        seed = ops.seed_from_key(np.asarray(jax.random.split(k_step, 3)[0]))
        flat, _ = step(flat, store.sample(u), seed)
        if t % 100 == 0:
            _, ra = revaluate(rspec.unravel(rflat), rev)
            _, pa = evaluate(spec.unravel(flat), pev)
            accs.append((float(ra), float(pa)))
    for ra, pa in accs:
        assert abs(ra - pa) <= 2 / (N * 128), accs
    assert accs[-1][1] >= 0.25, accs
    assert float(np.abs(flat.numpy() - np.asarray(rflat)).max()) < 1.5e-5
