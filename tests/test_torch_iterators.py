"""The port's iterator views of the tile schedule (``data/iterators.py``)
yield what the JAX package's yield, for each case of
tests/test_iterators.py."""

import numpy as np
import pytest

from cnn_gp_tpu.data import ArrayDataset as JArrayDataset
from cnn_gp_tpu.data import DiagIterator as JDiag
from cnn_gp_tpu.data import ProductIterator as JProduct
from cnn_gp_tpu_torch.data import ArrayDataset, DiagIterator, ProductIterator


def _same_yields(got, want):
    """Equal yields, batch for batch: (same, (i, (x, y)), (j, (z, w)))."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for (gi, gb), (wi, wb) in zip(g[1:], w[1:]):
            assert gi == wi
            for ga, wa in zip(gb, wb):
                if wa is None:
                    assert ga is None
                else:
                    np.testing.assert_array_equal(ga, wa)
    return got


def test_product_iterator_symmetric_order():
    x = np.arange(25 * 4, dtype=np.float32).reshape(25, 1, 2, 2)
    items = _same_yields(ProductIterator(10, x), JProduct(10, x))
    coords = [(i // 10, j // 10) for _, (i, _), (j, _) in items]
    assert coords == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    assert [s for s, _, _ in items] == [True, False, False, True, False,
                                        True]
    same, (i, (xb, yb)), (j, (zb, wb)) = items[-1]
    assert xb.shape[0] == 5 and yb is None  # ragged last batch
    assert len(ProductIterator(10, x)) == 6


def test_product_iterator_dataset_labels():
    imgs = np.random.RandomState(0).rand(20, 1, 2, 2).astype(np.float32)
    labels = np.arange(20, dtype=np.int64)
    items = _same_yields(ProductIterator(10, ArrayDataset(imgs, labels)),
                         JProduct(10, JArrayDataset(imgs, labels)))
    for same, (i, (xb, yb)), (j, (zb, wb)) in items:
        np.testing.assert_array_equal(yb, np.arange(i, i + len(xb)))
        np.testing.assert_array_equal(wb, np.arange(j, j + len(zb)))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_product_iterator_worker_split(rank):
    x = np.random.RandomState(1).rand(40, 1, 2, 2).astype(np.float32)
    _same_yields(ProductIterator(10, x, worker_rank=rank, n_workers=3),
                 JProduct(10, x, worker_rank=rank, n_workers=3))
    coords = {(i, j) for r in range(3)
              for _, (i, _), (j, _) in ProductIterator(
                  10, x, worker_rank=r, n_workers=3)}
    assert len(coords) == 10  # 4 batches => 10 upper-tri blocks


def test_product_iterator_cross():
    x = np.zeros((20, 1, 2, 2), np.float32)
    z = np.ones((30, 1, 2, 2), np.float32)
    items = _same_yields(ProductIterator(10, x, z), JProduct(10, x, z))
    assert len(items) == 6
    assert all(not s for s, _, _ in items)
    assert items[0][2][1][0][0, 0, 0, 0] == 1.0


@pytest.mark.parametrize("cross", [False, True])
def test_diag_iterator(cross):
    x = np.random.RandomState(2).rand(25, 1, 2, 2).astype(np.float32)
    z = x[::-1].copy() if cross else None
    items = _same_yields(DiagIterator(10, x, z), JDiag(10, x, z))
    assert len(items) == 3
    s, (i0, (xb, yb)), (j0, (zb, wb)) = items[-1]
    assert s is not cross and i0 == 20 and xb.shape[0] == 5
