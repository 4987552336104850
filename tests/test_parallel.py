"""Column data-parallel scaling on the virtual 8-device CPU mesh.

Reference parity (SURVEY §2.8): the reference's OpenMP column blocking
and MPI-count invariance — shard results must be bit-identical to the
single-device run, and the scaling harness must report sane
efficiencies.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

IFS_IN = "/root/reference/test/ifs/ecrad_meridian.nc"

needs_ref = pytest.mark.skipif(not os.path.exists(IFS_IN),
                               reason="reference test files unavailable")


@pytest.fixture(scope="module")
def setup_and_inputs():
    from ecrad_tpu.config import RadiationConfig, Solver
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    cfg = RadiationConfig(i_solver_sw=Solver.TRIPLECLOUDS,
                          i_solver_lw=Solver.TRIPLECLOUDS,
                          use_aerosols=False,
                          directory_name="/root/reference/data")
    setup = setup_radiation(cfg)
    parts = read_input(IFS_IN)
    return setup, parts


@needs_ref
def test_sharded_matches_single_device(setup_and_inputs):
    """Column sharding must not change results (the reference's
    MPI-count-invariance, CHANGELOG:17-19)."""
    from ecrad_tpu.interface import radiation
    from ecrad_tpu.parallel.sharding import (column_mesh, column_parallel,
                                             shard_columns)
    setup, parts = setup_and_inputs
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"

    fn = jax.jit(lambda *a: radiation(setup, *a))
    flux_single = fn(*parts)

    mesh = column_mesh(jax.devices()[:8])
    sharded = shard_columns(parts, mesh)
    flux_sharded = column_parallel(lambda *a: radiation(setup, *a),
                                   mesh)(*sharded)

    np.testing.assert_allclose(np.asarray(flux_single.lw_up),
                               np.asarray(flux_sharded.lw_up),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(flux_single.sw_dn),
                               np.asarray(flux_sharded.sw_dn),
                               rtol=0, atol=2e-3)


def test_init_distributed_single_host():
    from ecrad_tpu.parallel.scaling import init_distributed
    info = init_distributed()
    assert info["process_count"] == 1
    assert info["global_devices"] >= 1


@needs_ref
def test_host_column_slice_covers_all():
    from ecrad_tpu.parallel.scaling import host_column_slice
    sl = host_column_slice(32)
    assert sl == slice(0, 32)  # single host reads everything


@needs_ref
def test_chunk_columns_matches_unchunked(setup_and_inputs):
    """lax.map column blocking must be exactly equivalent (the memory
    analogue of the reference's nblocksize blocks)."""
    from ecrad_tpu.interface import radiation
    from ecrad_tpu.parallel.scaling import chunk_columns
    setup, parts = setup_and_inputs
    fn = jax.jit(lambda *a: radiation(setup, *a))
    full = fn(*parts)
    # 32 columns in blocks of 10 (non-divisible: exercises padding)
    chunked = jax.jit(chunk_columns(
        lambda *a: radiation(setup, *a), 10))(*parts)
    np.testing.assert_allclose(np.asarray(full.lw_up),
                               np.asarray(chunked.lw_up), atol=2e-4)
    np.testing.assert_allclose(np.asarray(full.sw_dn),
                               np.asarray(chunked.sw_dn), atol=2e-3)


@needs_ref
def test_column_subset_recompute_bit_identical(setup_and_inputs):
    """The resume model (SURVEY §5): any subset of columns recomputes
    bit-identically because per-column seeds make columns independent
    (the reference's crashed-shard re-run property). Verified here for
    McICA, whose stochastic generator is the only RNG consumer."""
    from ecrad_tpu.config import RadiationConfig, Solver
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    cfg = RadiationConfig(i_solver_sw=Solver.MCICA,
                          i_solver_lw=Solver.MCICA,
                          use_aerosols=False,
                          directory_name="/root/reference/data")
    setup = setup_radiation(cfg)
    parts = read_input(IFS_IN)
    fn = jax.jit(lambda *a: radiation(setup, *a))
    full = fn(*parts)
    # re-run columns 5..13 alone (a "crashed shard")
    sub = tuple(jax.tree.map(
        lambda x: (x[5:13] if hasattr(x, "ndim") and x.ndim > 0
                   and x.shape[0] == parts[0].ncol else x), p)
        for p in parts)
    partial = fn(*sub)
    np.testing.assert_array_equal(np.asarray(full.lw_up)[5:13],
                                  np.asarray(partial.lw_up))
    np.testing.assert_array_equal(np.asarray(full.sw_dn)[5:13],
                                  np.asarray(partial.sw_dn))
    np.testing.assert_array_equal(np.asarray(full.cloud_cover_sw)[5:13],
                                  np.asarray(partial.cloud_cover_sw))
