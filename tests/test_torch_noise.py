"""The port's counter-hash noise stream (repro_torch.kernels.noise) against
the reference's interpret-mode generator: hash bits bitwise equal, normals
within 2 ULP (bitwise except where XLA's CPU square root is an estimate,
in the far tail)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_mix import dp_mix as ref_mix
from repro.kernels.dp_perturb.dp_perturb import _hash_bits
from repro_torch.kernels import noise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(a, b):
    """ULP distance of two float32 arrays of equal signs."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1])
def test_hash_bits_bitwise(seed):
    idx = np.arange(1 << 16, dtype=np.uint32) * np.uint32(2654435) + 12345
    want = np.asarray(_hash_bits(jnp.asarray(idx), jnp.int32(seed)))
    got = noise.hash_bits(torch.from_numpy(idx.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_normals_on_the_lattice():
    """Every 64th point of the 2^24 lattice plus its whole far tail."""
    k = np.arange(1 << 24, dtype=np.uint32)
    k = np.unique(np.concatenate([k[::64], k[:1 << 16], k[-(1 << 16):]]))
    bits = k << np.uint32(8)
    want = np.asarray(ref_mix._normal_from_bits(jnp.asarray(bits)))
    got = noise.normal_from_bits(torch.from_numpy(bits.astype(np.int64)))
    ulp = _ulp(got.numpy(), want)
    assert ulp.max() <= 2
    assert (ulp > 0).mean() < 1e-3          # bitwise almost everywhere
    assert np.all(np.isfinite(got.numpy()))


@pytest.mark.parametrize("shape,cw,col0,row0,seed", [
    ((6, 500), 512, 0, 0, 7),
    ((3, 257), 1024, 640, 0, -5),           # a column window
    ((4, 128), 384, 128, 5, 2**31 - 1),     # a row window
    ((2, 300), 300, 17, 2, 0),              # stride not a lane multiple
])
def test_normal_pair_windows(shape, cw, col0, row0, seed):
    g1, g2 = ref_mix._normal_pair_hash(shape, cw, jnp.int32(col0),
                                       jnp.int32(seed), row0=row0)
    t1, t2 = noise.normal_pair_hash(shape, cw, col0, seed, row0=row0)
    assert _ulp(t1.numpy(), g1).max() <= 2
    assert _ulp(t2.numpy(), g2).max() <= 2


def test_counters_wrap_like_uint32():
    """Counters past 2^32 wrap as the reference's uint32 arithmetic does."""
    shape, cw = (3, 64), (1 << 31) - 64
    g1, _ = ref_mix._normal_pair_hash(shape, cw, jnp.int32(5), jnp.int32(3))
    t1, _ = noise.normal_pair_hash(shape, cw, 5, 3)
    assert _ulp(t1.numpy(), g1).max() <= 2


def test_seed_tensor_on_device_matches_int():
    a = noise.normal_pair_hash((2, 64), 128, 0, 11)[0]
    b = noise.normal_pair_hash((2, 64), 128, torch.tensor(0, dtype=torch.int32),
                               torch.tensor([11], dtype=torch.int32)[0])[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
