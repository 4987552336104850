"""Multi-process distributed execution test.

Launches two real `jax.distributed` CPU processes, each reading its own
column slice of the meridian input via read_input_sharded, and asserts
the reassembled output matches a single-process run — the reference's
MPI-count-invariance property (CHANGELOG:17-19; rank-local NetCDF reads
in ifs/easy_netcdf_read_mpi.F90:141-177). This exercises
parallel/scaling.py init_distributed + read_input_sharded and
parallel/sharding.py's multi-process global-array assembly with >1
actual process, which the in-process 8-device tests cannot.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_worker.py")

needs_ref = pytest.mark.skipif(
    not os.path.isdir("/root/reference/test/ifs"),
    reason="reference test/ifs not available")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(nproc, pid, port):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        + [os.path.dirname(HERE)])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # 1 CPU device per process
    env["ECRAD_COORDINATOR"] = f"127.0.0.1:{port}"
    env["ECRAD_NUM_PROCESSES"] = str(nproc)
    env["ECRAD_PROCESS_ID"] = str(pid)
    return env


def _run_workers(nproc, outdir, port):
    procs = []
    outs = []
    for pid in range(nproc):
        out = os.path.join(outdir, f"out_{nproc}p_{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out],
            env=_worker_env(nproc, pid, port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p, out in zip(procs, outs):
        stdout, _ = p.communicate(timeout=1200)
        assert p.returncode == 0, (
            f"worker for {out} failed:\n{stdout.decode()[-4000:]}")
    return [np.load(o) for o in outs]


@needs_ref
def test_two_process_matches_single(tmp_path):
    single = _run_workers(1, str(tmp_path), _free_port())[0]
    duo = _run_workers(2, str(tmp_path), _free_port())
    assert {int(d["process_index"]) for d in duo} == {0, 1}
    for key in ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct",
                "lw_up_clear", "sw_dn_clear"):
        parts = sorted(duo, key=lambda d: int(d[key + "_row0"]))
        got = np.concatenate([d[key] for d in parts], axis=0)
        want = single[key]
        assert got.shape == want.shape
        scale = max(np.abs(want).max(), 1.0)
        # same tightness as the in-process shard-invariance test:
        # differences are XLA fusion-level only
        np.testing.assert_allclose(
            got, want, rtol=0, atol=2e-4 * scale,
            err_msg=f"{key}: 2-process run differs from single process")
