"""End-to-end clear-sky tests on the in-repository IFS slice.

Cloudless LW+SW, full RRTMG-IFS spectrum (ecrad_tpu/data/
cloudless_slice8.nam) on the 8 IFS columns x 137 levels of ecrad_tpu/
data/ifs_slice_8col.nc, in float32 on the CPU; the accuracy gate holds
it to the float64 truth tests/goldens/cloudless_slice8_f64.npz
(tools/make_slice_golden.py) with the bounds chip_smoke.py uses on the
GPU.
"""
import jax
import numpy as np
import pytest

from chip_smoke import F64_BOUNDS, GOLDEN
from ecrad_tpu.config import load_config_from_namelist
from ecrad_tpu.constants import STEFAN_BOLTZMANN
from ecrad_tpu.interface import radiation, setup_radiation
from ecrad_tpu.io.input_reader import read_input
from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE

INPUT = IFS_SLICE


@pytest.fixture(scope="module")
def fluxes():
    sl, thermo, gas, cloud, aer = read_input(INPUT)
    setup = setup_radiation(load_config_from_namelist(CLOUDLESS_NAMELIST))
    flux = jax.jit(lambda s, t, g: radiation(setup, s, t, g))(
        sl, thermo, gas)
    return sl, flux


@pytest.mark.parametrize("field", sorted(F64_BOUNDS))
def test_f32_matches_f64_truth(fluxes, field):
    """Per-field max-abs error of the float32 path against the pinned
    float64 truth, within the clear-sky contract (W m-2)."""
    _, flux = fluxes
    want = np.load(GOLDEN)[field]
    got = np.asarray(getattr(flux, field), np.float64)
    assert got.shape == want.shape == (8, 138)
    err = float(np.abs(got - want).max())
    assert err <= F64_BOUNDS[field], f"{field}: {err} W m-2"


def test_physical_ranges(fluxes):
    sl, flux = fluxes
    olr = np.asarray(flux.lw_up[:, 0])
    assert (olr > 120).all() and (olr < 360).all()
    # OLR is emission from the surface and the levels: between the
    # black-body fluxes of the column's coldest and warmest temperature
    thermo = read_input(INPUT)[1]
    t = np.concatenate([np.asarray(thermo.temperature_hl),
                        np.asarray(sl.skin_temperature)[:, None]], axis=1)
    assert (olr > STEFAN_BOLTZMANN * t.min(axis=1) ** 4).all()
    assert (olr < STEFAN_BOLTZMANN * t.max(axis=1) ** 4).all()
    # LW down at TOA is zero
    np.testing.assert_allclose(np.asarray(flux.lw_dn[:, 0]), 0.0,
                               atol=1e-3)
    # surface LW down positive and below sigma*T^4
    sfc_dn = np.asarray(flux.lw_dn[:, -1])
    assert (sfc_dn > 50).all() and (sfc_dn < 500).all()


def test_sw_consistency(fluxes):
    sl, flux = fluxes
    mu0 = np.asarray(sl.cos_sza)
    toa_dn = np.asarray(flux.sw_dn[:, 0])
    # TOA downward = S0 * mu0 for daylight columns
    expect = sl.solar_irradiance * np.maximum(mu0, 0.0)
    np.testing.assert_allclose(toa_dn, expect, rtol=1e-4, atol=1e-3)
    # night columns: all SW fluxes zero
    night = mu0 <= 0.0
    assert np.abs(np.asarray(flux.sw_dn)[night]).max() == 0.0
    assert np.abs(np.asarray(flux.sw_up)[night]).max() == 0.0
    # energy: TOA up < TOA dn; direct <= total dn
    day = mu0 > 0.0
    assert (np.asarray(flux.sw_up[:, 0])[day]
            < toa_dn[day]).all()
    # f32 rounding can put direct a few 0.01 W/m2 above total
    assert (np.asarray(flux.sw_dn_direct) <= np.asarray(flux.sw_dn)
            + 0.05).all()


def test_flux_monotonic_decrease_direct(fluxes):
    """Direct beam only attenuates downward."""
    sl, flux = fluxes
    fdir = np.asarray(flux.sw_dn_direct)
    day = np.asarray(sl.cos_sza) > 0
    d = np.diff(fdir[day], axis=1)
    assert (d <= 1e-3).all()


def test_clear_equals_total_for_cloudless(fluxes):
    sl, flux = fluxes
    np.testing.assert_array_equal(np.asarray(flux.lw_up),
                                  np.asarray(flux.lw_up_clear))
    np.testing.assert_array_equal(np.asarray(flux.sw_dn),
                                  np.asarray(flux.sw_dn_clear))


def test_heating_rates_sane(fluxes):
    sl, flux = fluxes
    sl2, thermo, gas, cloud, aer = read_input(INPUT)
    hr_lw = np.asarray(flux.heating_rate_lw(thermo))
    # restrict to the troposphere/stratosphere (p > 100 hPa) and to
    # layers thicker than 10 hPa: upper-mesosphere rates and ultra-thin
    # surface layers with sharp temperature jumps legitimately reach
    # tens of K/day
    p_hl = np.asarray(thermo.pressure_hl)
    p_mid = 0.5 * (p_hl[:, :-1] + p_hl[:, 1:])
    dp = p_hl[:, 1:] - p_hl[:, :-1]
    sel = (p_mid > 1e4) & (dp > 1e3)
    assert hr_lw[sel].min() > -20 and hr_lw[sel].max() < 15
