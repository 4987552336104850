"""Multi-device scaling: distributed init, sharded ingest, column
blocking.

Reference parity (SURVEY §2.8/§5): the reference scales with an OpenMP
block loop per node plus MPI only for setup-time coefficient-table
broadcasts (rrtm_kgb*.F90 MPL_BROADCAST) and rank-0 NetCDF reads
(ifs/easy_netcdf_read_mpi.F90). Equivalents here:

 - `init_distributed`: jax.distributed initialization across hosts
   (coordinator env-driven); a no-op single-host.
 - `read_input_sharded`: every host reads only its own column slice of
   the NetCDF input (host-sharded ingest; the rank-0+broadcast pattern
   is unnecessary because coefficient tables are jit constants that XLA
   replicates to every device at compile time). Run the step on it
   with `sharding.column_parallel`.
 - `chunk_columns`: fixed-size column blocks (the driver's nblocksize).

The compute itself needs no collectives: columns are embarrassingly
parallel and each shard's physics is self-contained (the per-column
iseed makes any shard bit-reproducible in isolation — the reference's
MPI-count-invariance property, CHANGELOG:17-19).
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from .sharding import shard_columns


def init_distributed() -> Dict[str, int]:
    """Initialize jax.distributed from standard env vars when running
    multi-host; single-host is a no-op. Returns process info."""
    coord = os.environ.get("ECRAD_COORDINATOR")
    nproc = int(os.environ.get("ECRAD_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("ECRAD_PROCESS_ID", "0"))
    if coord and nproc > 1:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid)
    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": jax.local_device_count(),
            "global_devices": jax.device_count()}


def host_column_slice(ncol: int) -> slice:
    """The contiguous slice of columns this host should read
    (host-sharded ingest)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = -(-ncol // nproc)
    return slice(pid * per, min((pid + 1) * per, ncol))


def read_input_sharded(path: str, driver_config=None):
    """Read only this host's columns of the driver input, then shard
    over local devices. Single-host: equivalent to read_input +
    shard_columns. Run the step on the result with
    sharding.column_parallel."""
    from ..io.input_reader import read_input
    parts = read_input(path, driver_config)
    ncol = parts[0].ncol
    sl = host_column_slice(ncol)
    if jax.process_count() > 1:
        parts = tuple(jax.tree.map(
            lambda x: (x[sl] if hasattr(x, "ndim") and x.ndim > 0
                       and x.shape[0] == ncol else x), p)
            for p in parts)
        return shard_columns(parts, local_columns=sl.stop - sl.start)
    return shard_columns(parts)


def chunk_columns(run_fn: Callable, block_size: int) -> Callable:
    """Process columns in fixed-size blocks via lax.map.

    The memory-bounding analogue of the reference driver's `nblocksize`
    column blocks (driver/ecrad_driver.F90:277): peak activation memory
    scales with the block, not the batch — essential for SPARTACUS,
    whose per-layer region-coupled matrices are large. Trailing
    remainder columns are padded and cropped.
    """
    import jax

    def wrapped(*inputs):
        leaves, treedef = jax.tree.flatten(inputs)
        ncol = leaves[0].shape[0]
        nblk = -(-ncol // block_size)
        pad = nblk * block_size - ncol
        is_mapped = [hasattr(x, "ndim") and x.ndim >= 1
                     and x.shape[0] == ncol for x in leaves]

        def prep(x):
            if pad:
                x = jnp.concatenate(
                    [x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)
            return x.reshape((nblk, block_size) + x.shape[1:])

        mapped = tuple(prep(x) for x, m in zip(leaves, is_mapped) if m)
        static = [x for x, m in zip(leaves, is_mapped) if not m]

        def block_fn(blk_leaves):
            blk_iter = iter(blk_leaves)
            stat_iter = iter(static)
            full = [next(blk_iter) if m else next(stat_iter)
                    for m in is_mapped]
            return run_fn(*jax.tree.unflatten(treedef, full))

        out = jax.lax.map(block_fn, mapped)

        def unprep(x):
            if not hasattr(x, "ndim") or x.ndim < 2:
                return x
            flat = x.reshape((nblk * block_size,) + x.shape[2:])
            return flat[:ncol]

        return jax.tree.map(unprep, out)

    return wrapped
