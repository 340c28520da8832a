"""Data parity: the port's numpy copies of the synthetic datasets and the
non-IID partitioner are bit-identical to the reference for the same
seeds (tolerance: none — exact equality)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import paper_models as rcfg  # noqa: E402
from repro.data import partition as rpart  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro_torch.configs import paper_models as pcfg  # noqa: E402
from repro_torch.data import partition as ppart  # noqa: E402
from repro_torch.data import synthetic as psyn  # noqa: E402


@pytest.mark.parametrize("name", ["fmnist_cnn", "cifar_vgg11", "kws_cnn"])
def test_configs_match(name):
    assert pcfg.CNN_CONFIGS[name].__dict__ == rcfg.CNN_CONFIGS[name].__dict__
    assert (pcfg.reduced(pcfg.CNN_CONFIGS[name]).__dict__
            == rcfg.reduced(rcfg.CNN_CONFIGS[name]).__dict__)


@pytest.mark.parametrize("name,seed,noise", [("fmnist_cnn", 0, 0.35),
                                             ("kws_cnn", 3, 1.2),
                                             ("cifar_vgg11", 7, 0.35)])
def test_make_classification_bit_identical(name, seed, noise):
    rtr, rte = rsyn.make_classification(rcfg.CNN_CONFIGS[name], n_train=300,
                                        n_test=50, seed=seed, noise=noise)
    ptr, pte = psyn.make_classification(pcfg.CNN_CONFIGS[name], n_train=300,
                                        n_test=50, seed=seed, noise=noise)
    for r, p in ((rtr, ptr), (rte, pte)):
        assert p.x.dtype == r.x.dtype and p.y.dtype == r.y.dtype
        np.testing.assert_array_equal(p.x, r.x)
        np.testing.assert_array_equal(p.y, r.y)
        assert (p.n_classes, p.name) == (r.n_classes, r.name)


@pytest.mark.parametrize("clients,ell,seed", [(100, 2, 0), (8, 2, 0),
                                              (20, 3, 1), (10, 0, 5),
                                              (7, 10, 2), (13, 4, 9)])
def test_noniid_partition_bit_identical(clients, ell, seed):
    labels = np.random.default_rng(seed).integers(0, 10, size=2000)
    ref = rpart.noniid_partition(labels, clients, ell, 10, seed=seed)
    port = ppart.noniid_partition(labels, clients, ell, 10, seed=seed)
    assert len(port) == len(ref)
    for p, r in zip(port, ref, strict=True):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
