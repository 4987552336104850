"""Worker process for the multi-process distributed test.

Run as: python distributed_worker.py <out.npz>
with ECRAD_COORDINATOR / ECRAD_NUM_PROCESSES / ECRAD_PROCESS_ID set
(the env contract of ecrad_tpu.parallel.scaling.init_distributed).

Each process reads ONLY its own column slice of the meridian input
(read_input_sharded — the analogue of the reference's per-rank NetCDF
read, ifs/easy_netcdf_read_mpi.F90:141-177), runs the full radiation
step over the global 2-device mesh as one program per device
(column_parallel), and saves its addressable output
shards. The parent test reassembles and compares against a
single-process run (the reference's MPI-count invariance,
CHANGELOG:17-19).
"""
import os
import sys

import numpy as np

FLUX_KEYS = ["lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
             "lw_up_clear", "sw_dn_clear"]


def main(out_path):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.parallel.scaling import (init_distributed,
                                            read_input_sharded)
    from ecrad_tpu.parallel.sharding import column_mesh, column_parallel

    info = init_distributed()
    cfg = load_config_from_namelist(
        "/root/reference/test/ifs/configCY47R1.nam",
        directory_name="/root/reference/data",
        do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
        do_canopy_fluxes_lw=False, i_solver_sw=Solver.CLOUDLESS,
        i_solver_lw=Solver.CLOUDLESS)
    setup = setup_radiation(cfg)
    parts = read_input_sharded("/root/reference/test/ifs/ecrad_meridian.nc")

    flux = column_parallel(lambda *a: radiation(setup, *a),
                           column_mesh())(*parts)
    out = {"process_index": np.int64(info["process_index"]),
           "process_count": np.int64(info["process_count"])}
    for key in FLUX_KEYS:
        arr = getattr(flux, key)
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        out[key] = np.concatenate([np.asarray(s.data) for s in shards],
                                  axis=0)
        start = shards[0].index[0].start or 0
        out[key + "_row0"] = np.int64(start)
    np.savez(out_path, **out)
    print(f"worker {info['process_index']}/{info['process_count']} done")


if __name__ == "__main__":
    main(sys.argv[1])
