"""Float64 validation vs the reference binary's golden output.

The reference ecrad builds in double precision by default (parkind1
JPRB); our default compute dtype is f32 for throughput. Running the
clear-sky path with dtype="float64" must reproduce the reference golden
to ~1e-4 W/m2 — demonstrating the remaining f32-mode differences
(~1 W/m2 SW) are accumulation precision, not physics.

Runs in a subprocess because jax_enable_x64 is a process-global switch.
"""
import os
import subprocess
import sys

import pytest

SCRIPT = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, "@REPO@")
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
from ecrad_tpu.config import load_config_from_namelist
from ecrad_tpu.interface import radiation, setup_radiation
from ecrad_tpu.io.input_reader import read_input
from scipy.io import netcdf_file
inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
cfg = load_config_from_namelist(
    "/root/reference/test/ifs/configCY47R1.nam",
    directory_name="/root/reference/data",
    do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
    do_canopy_fluxes_lw=False, dtype="float64")
setup = setup_radiation(cfg)
flux = radiation(setup, *inputs)
ref = netcdf_file(
    "/root/reference/test/ifs/ecrad_meridian_default_out_REFERENCE.nc",
    mmap=False)
worst = 0.0
for ours, theirs in (("lw_up_clear", "flux_up_lw_clear"),
                     ("lw_dn_clear", "flux_dn_lw_clear"),
                     ("sw_up_clear", "flux_up_sw_clear"),
                     ("sw_dn_clear", "flux_dn_sw_clear")):
    a = np.asarray(getattr(flux, ours))
    b = ref.variables[theirs][:]
    err = float(np.abs(a - b).max())
    print(ours, err)
    worst = max(worst, err)
assert worst < 5e-3, f"f64 clear-sky error vs reference golden: {worst}"
print("OK")
"""


def test_f64_clear_sky_matches_reference_golden():
    if not os.path.exists(
            "/root/reference/test/ifs/ecrad_meridian.nc"):
        pytest.skip("reference inputs unavailable")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # single-device CPU is fine here
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("@REPO@", repo)],
        capture_output=True, text=True, timeout=3000, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "OK" in res.stdout, res.stdout


# Per-field max-abs bounds (W/m2) for the f32 SPARTACUS path vs the
# pinned f64 CPU truth: ~2x the measured CPU-f32 errors (lw 6e-4 /
# sw 0.10, the Meador-Weaver f32 floor shared by every solver).
SPARTACUS_F64_BOUNDS = {
    "lw_up": 0.01, "lw_dn": 0.01,
    "sw_up": 0.20, "sw_dn": 0.20, "sw_dn_direct": 0.01,
    "lw_up_clear": 0.01, "lw_dn_clear": 0.01,
    "sw_up_clear": 0.20, "sw_dn_clear": 0.20,
}


def test_spartacus_f32_vs_f64_golden(test_ifs_dir):
    """CPU-f32 SPARTACUS production path vs the pinned f64 CPU truth
    (tests/goldens/spartacus_meridian_f64.npz), with per-field bounds
    (SPARTACUS_F64_BOUNDS). Round 4's 5-10 W/m2 lw_dn f32 conditioning
    error (the -A^-1 B extraction on the full-layer exponential,
    cond ~ e^{2 od gamma}) would trip this at ~100x the bound; the
    round-5 adding-doubling reformulation (matrix.py
    expm_reftrans_lw_g/sw_g) measures lw ~6e-4 / sw ~0.10 W/m2."""
    import jax
    import numpy as np
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    golden_path = os.path.join(repo, "tests", "goldens",
                               "spartacus_meridian_f64.npz")
    if not os.path.exists(golden_path):
        pytest.skip("f64 golden not generated")
    golden = np.load(golden_path)
    inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
    cfg = load_config_from_namelist(
        "/root/reference/test/ifs/configCY47R1.nam",
        directory_name="/root/reference/data",
        do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
        do_canopy_fluxes_lw=False, i_solver_sw=Solver.SPARTACUS,
        i_solver_lw=Solver.SPARTACUS, do_3d_effects=True)
    setup = setup_radiation(cfg)
    flux = jax.jit(lambda *a: radiation(setup, *a))(*inputs)
    failures = []
    for key, bound in SPARTACUS_F64_BOUNDS.items():
        got = np.asarray(getattr(flux, key), np.float64)
        err = float(np.abs(got - golden[key]).max())
        if err >= bound:
            failures.append(f"{key}: {err:.4f} >= {bound}")
    assert not failures, failures


@pytest.mark.parametrize("solver_name", ["tripleclouds", "homogeneous",
                                         "cloudless"])
def test_solver_f32_vs_f64_golden(test_ifs_dir, solver_name):
    """Per-field f32-vs-f64 accuracy contract for the remaining
    deterministic solvers (SPARTACUS has its own, tighter test above;
    McICA is statistical). Bounds are ~2x the round-5 measured CPU-f32
    errors; the shared SW floor is the Meador-Weaver f32 resonance
    (BASELINE.md round-4 attribution)."""
    import jax
    import numpy as np
    from ecrad_tpu.config import Solver, load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    golden_path = os.path.join(repo, "tests", "goldens",
                               f"{solver_name}_meridian_f64.npz")
    if not os.path.exists(golden_path):
        pytest.skip("f64 golden not generated")
    golden = np.load(golden_path)
    solver = {"tripleclouds": Solver.TRIPLECLOUDS,
              "homogeneous": Solver.HOMOGENEOUS,
              "cloudless": Solver.CLOUDLESS}[solver_name]
    inputs = read_input("/root/reference/test/ifs/ecrad_meridian.nc")
    cfg = load_config_from_namelist(
        "/root/reference/test/ifs/configCY47R1.nam",
        directory_name="/root/reference/data",
        do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
        do_canopy_fluxes_lw=False, i_solver_sw=solver,
        i_solver_lw=solver)
    setup = setup_radiation(cfg)
    flux = jax.jit(lambda *a: radiation(setup, *a))(*inputs)
    bounds = {"lw_up": 0.02, "lw_dn": 0.02,
              "sw_up": 0.30, "sw_dn": 0.30, "sw_dn_direct": 0.02,
              "lw_up_clear": 0.01, "lw_dn_clear": 0.01,
              "sw_up_clear": 0.20, "sw_dn_clear": 0.20}
    failures = []
    for key, bound in bounds.items():
        got = np.asarray(getattr(flux, key), np.float64)
        err = float(np.abs(got - golden[key]).max())
        if err >= bound:
            failures.append(f"{key}: {err:.4f} >= {bound}")
    assert not failures, failures
