"""The column tiler (ecrad_tpu/io/tiling.py)."""
import jax
import numpy as np
import pytest

from ecrad_tpu.io.input_reader import read_input
from ecrad_tpu.io.tiling import tile_columns
from ecrad_tpu.paths import IFS_SLICE


@pytest.fixture(scope="module")
def inputs():
    return read_input(IFS_SLICE)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_same_seed_same_batch_other_seed_differs(inputs):
    a = _leaves(tile_columns(inputs, 3, seed=7))
    b = _leaves(tile_columns(inputs, 3, seed=7))
    c = _leaves(tile_columns(inputs, 3, seed=8))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_copy_zero_is_the_input_and_copies_differ(inputs):
    sl, th, gas, cloud, aer = tile_columns(inputs, 4, seed=0)
    ncol = inputs[0].ncol
    assert sl.ncol == 4 * ncol
    for tiled, orig in zip((sl, th, gas, cloud, aer), inputs):
        for x, y in zip(_leaves(tiled), _leaves(orig)):
            if x.ndim > 0 and x.shape[0] == 4 * ncol:
                np.testing.assert_array_equal(x[:ncol], y)
            else:
                np.testing.assert_array_equal(x, y)
    t = np.asarray(th.temperature_hl)
    assert not np.array_equal(t[ncol:2 * ncol], t[:ncol])
    mu0 = np.asarray(sl.cos_sza)
    assert (np.abs(mu0) <= 1.0).all()
    alb = np.asarray(sl.sw_albedo)
    assert ((alb >= 0.0) & (alb <= 1.0)).all()
    with pytest.raises(ValueError):
        tile_columns(inputs, 0)
