"""The port's own copies of the data, partition and minibatch code are
bit-identical to the JAX package's (numpy on both sides, one seed)."""
import numpy as np
import pytest

from repro.data import batches as r_batches
from repro.data import dirichlet_partition as r_partition
from repro.data import make_classification_data as r_make

from repro_torch.data import batches, dirichlet_partition
from repro_torch.data import make_classification_data


@pytest.mark.parametrize("seed,size,ch,per_class", [
    (0, 8, 3, 6), (1, 16, 1, 4), (7, 32, 3, 2)])
def test_classification_data_is_bitwise_equal(seed, size, ch, per_class):
    kw = dict(num_classes=5, size=size, ch=ch, train_per_class=per_class,
              test_per_class=per_class // 2 + 1)
    want, got = r_make(seed, **kw), make_classification_data(seed, **kw)
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed,n_clients", [(0, 5), (3, 3), (11, 10)])
def test_dirichlet_partition_is_bitwise_equal(alpha, seed, n_clients):
    labels = np.random.default_rng(seed).integers(0, 10, 400)
    want = r_partition(labels, n_clients, alpha, seed=seed)
    got = dirichlet_partition(labels, n_clients, alpha, seed=seed)
    assert len(got) == len(want) == n_clients
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dirichlet_partition_repairs_starving_clients_the_same_way():
    labels = np.random.default_rng(0).integers(0, 10, 60)
    want = r_partition(labels, 25, 0.05, seed=1, max_tries=2)
    got = dirichlet_partition(labels, 25, 0.05, seed=1, max_tries=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch_size,drop_last", [(7, False), (8, True)])
def test_batches_stream_is_equal(batch_size, drop_last):
    x = np.arange(50 * 2, dtype=np.float32).reshape(50, 2)
    y = np.arange(50, dtype=np.int32)
    kw = dict(seed=4, epochs=3, drop_last=drop_last)
    want = list(r_batches(x, y, batch_size, **kw))
    got = list(batches(x, y, batch_size, **kw))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
