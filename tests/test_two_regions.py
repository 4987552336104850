"""nregions=2 configs must run on every solver that splits regions.
Reference: radiation_config.F90 nregions (2 or 3),
radiation_regions.F90:35-92 (2-region split)."""
import jax
import numpy as np
import pytest

from ecrad_tpu.config import Solver, load_config_from_namelist
from ecrad_tpu.interface import radiation, setup_radiation
from ecrad_tpu.io.input_reader import read_input

INPUT = "/root/reference/test/ifs/ecrad_meridian.nc"
NAMELIST = "/root/reference/test/ifs/configCY47R1.nam"


@pytest.fixture(scope="module")
def inputs(test_ifs_dir):
    return read_input(INPUT)


def run(inputs, solver, **kw):
    cfg = load_config_from_namelist(
        NAMELIST, directory_name="/root/reference/data",
        do_save_spectral_flux=False, do_canopy_fluxes_sw=False,
        do_canopy_fluxes_lw=False, i_solver_sw=solver,
        i_solver_lw=solver, nregions=2, **kw)
    setup = setup_radiation(cfg)
    return jax.jit(lambda *a: radiation(setup, *a))(*inputs)


def test_tripleclouds_two_regions(inputs):
    """2-region Tripleclouds runs and gives finite, bounded fluxes."""
    flux = run(inputs, Solver.TRIPLECLOUDS)
    for name in ("lw_up", "lw_dn", "sw_up", "sw_dn"):
        a = np.asarray(getattr(flux, name))
        assert np.isfinite(a).all(), name
    day = np.asarray(inputs[0].cos_sza) > 0
    assert (np.asarray(flux.sw_up[:, 0])[day]
            <= np.asarray(flux.sw_dn[:, 0])[day] + 1e-2).all()


def test_spartacus_two_regions(inputs):
    flux = run(inputs, Solver.SPARTACUS, do_3d_effects=True)
    for name in ("lw_up", "lw_dn", "sw_up", "sw_dn"):
        a = np.asarray(getattr(flux, name))
        assert np.isfinite(a).all(), name
    day = np.asarray(inputs[0].cos_sza) > 0
    assert (np.asarray(flux.sw_up[:, 0])[day]
            <= np.asarray(flux.sw_dn[:, 0])[day] + 1e-2).all()
