"""The port's data path against the reference: the synthetic dataset and
the Dirichlet partition bitwise equal, the pinned eval batch equal, and
``ClassificationStore.sample`` fed the reference's uniforms picking the
reference's samples."""
import jax
import numpy as np
import pytest
import torch

from repro.data import device as ref_device
from repro.data import partition as ref_partition
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)


@pytest.mark.parametrize("n,seed", [(500, 0), (1234, 7)])
def test_dataset_and_partition_bitwise(n, seed):
    x, y = classification_dataset(n, seed=seed)
    rx, ry = ref_synthetic.classification_dataset(n, seed=seed)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.dtype == rx.dtype and y.dtype == ry.dtype
    for workers, alpha in ((4, 0.5), (7, 0.1)):
        parts = dirichlet_partition(y, workers, alpha=alpha, seed=seed)
        ref = ref_partition.dirichlet_partition(ry, workers, alpha=alpha,
                                                seed=seed)
        assert len(parts) == len(ref)
        for a, b in zip(parts, ref):
            np.testing.assert_array_equal(a, b)


def test_eval_batch_equal():
    x, y = classification_dataset(400, seed=1)
    parts = dirichlet_partition(y, 5, seed=1)
    got = FederatedBatcher(x, y, parts, 8).full(32)
    want = ref_pipeline.FederatedBatcher(x, y, parts, 8, seed=1).full(32)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k])


def test_store_sample_replays_reference_uniforms():
    x, y = classification_dataset(600, seed=2)
    parts = dirichlet_partition(y, 6, alpha=0.3, seed=2)
    ref = ref_device.ClassificationStore.build(x, y, parts, 16)
    store = ClassificationStore.build(x, y, parts, 16, device="cpu")
    for s in range(3):
        key = jax.random.PRNGKey(s)
        want = ref.sample(key)
        u = np.array(jax.random.uniform(key, (6, 16)))
        got = store.sample(torch.from_numpy(u))
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
        np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    # the edge of the rule: u just below 1 picks the last pool entry
    u = torch.full((6, 16), float(np.nextafter(np.float32(1), 0)))
    last = store.sample(u)["y"][:, 0].numpy()
    np.testing.assert_array_equal(last, y[[p[-1] for p in parts]])


def test_store_uniforms_come_from_the_generator():
    x, y = classification_dataset(300, seed=3)
    parts = dirichlet_partition(y, 3, seed=3)
    store = ClassificationStore.build(x, y, parts, 4, device="cpu")
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(store.uniforms(g1), store.uniforms(g2))
    u = store.uniforms(g1)
    assert u.shape == (3, 4) and float(u.min()) >= 0 and float(u.max()) < 1
