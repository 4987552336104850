"""Column sharding as one program per device (parallel/sharding.py
column_parallel) on the 8 virtual CPU devices of the test run: the
step holds no collectives, every flux field matches a one-device run
of the same columns, and only leaves on the column axis are split."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from __graft_entry__ import _example_inputs, _flagship_config
from ecrad_tpu.interface import radiation, setup_radiation
from ecrad_tpu.parallel.sharding import (column_mesh, column_parallel,
                                         count_collectives, shard_columns)


def test_column_parallel_matches_one_device_without_collectives():
    devices = jax.devices()
    assert len(devices) == 8
    mesh = column_mesh(devices)
    setup = setup_radiation(_flagship_config())
    host = _example_inputs(ncol=16, nlev=10)
    step = column_parallel(lambda *a: radiation(setup, *a), mesh)
    args = shard_columns(host, mesh)
    compiled = step.lower(*args).compile()
    assert count_collectives(compiled.as_text()) == {}
    flux = compiled(*args)
    assert flux.lw_up.sharding.spec[0] == "columns"
    ref = jax.jit(lambda *a: radiation(setup, *a))(
        *jax.device_put(host, devices[0]))
    for a, b in zip(jax.tree.leaves(flux), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


def test_column_parallel_passes_per_band_leaves_whole():
    """spectral_solar_scaling is (nbands_sw=14,): on a 2-device mesh its
    length divides the mesh, but it is not a column leaf, so every
    device gets all 14 bands."""
    devices = jax.devices()[:2]
    mesh = column_mesh(devices)
    cfg = dataclasses.replace(_flagship_config(),
                              use_spectral_solar_scaling=True)
    setup = setup_radiation(cfg)
    single_level, *rest = _example_inputs(ncol=4, nlev=10)
    single_level = single_level.replace(
        cos_sza=jnp.full((4,), 0.6, jnp.float32),
        spectral_solar_scaling=jnp.linspace(0.8, 1.2, 14,
                                            dtype=jnp.float32))
    host = (single_level, *rest)
    args = shard_columns(host, mesh)
    assert args[0].spectral_solar_scaling.sharding.spec == P()
    assert args[0].cos_sza.sharding.spec == P("columns")
    flux = column_parallel(lambda *a: radiation(setup, *a), mesh)(*args)
    ref = jax.jit(lambda *a: radiation(setup, *a))(
        *jax.device_put(host, devices[0]))
    for a, b in zip(jax.tree.leaves(flux), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


def test_column_parallel_splits_only_the_column_axis():
    """A (16,) leaf next to 8 columns divides the 8-device mesh but is
    not on the column axis: each device sums all of it."""
    mesh = column_mesh(jax.devices())
    x = jnp.arange(8 * 3, dtype=jnp.float32).reshape(8, 3)
    bands = jnp.arange(16, dtype=jnp.float32)
    out = column_parallel(lambda x, b: x + b.sum(), mesh)(
        *shard_columns((x, bands), mesh))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(x) + float(bands.sum()))


def test_column_parallel_rejects_columns_that_do_not_divide():
    mesh = column_mesh(jax.devices())
    x = jnp.ones((12, 3), jnp.float32)
    with pytest.raises(ValueError, match="12 columns"):
        column_parallel(lambda x: 2.0 * x, mesh)(x)


def test_count_collectives_reads_hlo_ops():
    hlo = ("%x = f32[8]{0} all-reduce(f32[8]{0} %p), replica_groups={}\n"
           "%y = f32[8]{0} all-gather-start(f32[2]{0} %q)\n"
           "%z = f32[8]{0} add(f32[8]{0} %x, f32[8]{0} %y)\n")
    assert count_collectives(hlo) == {"all-reduce": 1, "all-gather": 1}
