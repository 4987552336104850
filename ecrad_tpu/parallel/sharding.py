"""Column sharding over the device mesh.

The radiation problem is embarrassingly parallel over columns
(SURVEY §2.8: the reference's OpenMP block loop / MPI table broadcast).
Here: one 1-D mesh axis 'columns'; every per-column array is sharded on
its leading axis, coefficient tables are replicated jit constants.
`column_parallel` runs the radiation step as one program per device on
that device's columns (shard_map), so the step needs no collectives,
whatever kernels it calls; only I/O moves data between devices.
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "columns"
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")


def column_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), axis_names=(AXIS,))


def column_count(args) -> int:
    """The column count of radiation-style arguments: the first
    argument's `ncol` (SingleLevel), else its first leaf's leading
    dimension."""
    ncol = getattr(args[0], "ncol", None)
    return ncol if ncol is not None else np.shape(jax.tree.leaves(
        args[0])[0])[0]


def _is_column_leaf(x, ncol) -> bool:
    return np.ndim(x) > 0 and np.shape(x)[0] == ncol


def shard_columns(pytrees, mesh: Optional[Mesh] = None,
                  local_columns: Optional[int] = None):
    """Place every array whose leading axis is the column axis (length
    `column_count(pytrees)`) sharded on it over the mesh; every other
    leaf (scalars, per-band arrays) is replicated. Columns that do not
    divide by the mesh size are replicated too.

    When the mesh spans multiple processes (multi-host analogue of the
    reference's MPI ranks, ifs/easy_netcdf_read_mpi.F90), each process
    holds only its own column slice of the input; leaves whose leading
    dim equals `local_columns` are assembled into global arrays from the
    per-process shards, everything else is treated as replicated."""
    mesh = mesh or column_mesh()
    ndev = mesh.devices.size
    multiproc = len({d.process_index for d in mesh.devices.flat}) > 1

    if multiproc:
        col_sharding = NamedSharding(mesh, P(AXIS))
        rep_sharding = NamedSharding(mesh, P())

        def place_mp(x):
            if not hasattr(x, "ndim") or x.ndim == 0:
                return x
            x = np.asarray(x)
            if local_columns is not None and x.shape[0] == local_columns:
                return jax.make_array_from_process_local_data(
                    col_sharding, x)
            return jax.make_array_from_process_local_data(rep_sharding, x)

        return jax.tree.map(place_mp, pytrees)

    ncol = column_count(pytrees)
    split = ncol % ndev == 0

    def place(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        spec = P(AXIS) if split and _is_column_leaf(x, ncol) else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, pytrees)


def column_parallel(fn: Callable, mesh: Mesh) -> Callable:
    """jit(fn) over column-sharded arguments (shard_columns), as one
    program per device on that device's columns. Leaves whose leading
    axis is the column axis (length `column_count(args)`) are split
    over the mesh, every other leaf is passed whole to each device;
    every output is split on its leading (column) axis. The column
    count must divide by the mesh size."""
    ndev = mesh.devices.size

    def run(*args):
        ncol = column_count(args)
        if ncol % ndev:
            raise ValueError(f"{ncol} columns do not divide over "
                             f"{ndev} devices")
        specs = jax.tree.map(
            lambda x: P(AXIS) if _is_column_leaf(x, ncol) else P(), args)
        step = jax.shard_map(fn, mesh=mesh, in_specs=specs,
                             out_specs=P(AXIS), check_vma=False)
        return step(*args)

    return jax.jit(run)


def count_collectives(hlo_text: str) -> dict:
    """Cross-device collective ops in compiled HLO text, by op name."""
    counts = {}
    for name in COLLECTIVES:
        # op invocations ("= f32[..] all-gather(" / "all-gather-start(")
        n = len(re.findall(rf"\s{name}(?:-start)?\(", hlo_text))
        if n:
            counts[name] = n
    return counts
