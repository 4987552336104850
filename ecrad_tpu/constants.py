"""Physical constants for the radiation scheme.

Reference parity: /root/reference/radiation/radiation_constants.F90 and
/root/reference/ifsaux/yomcst.F90 (IFS values).
"""

# Acceleration due to gravity (m s-2)
ACCEL_DUE_TO_GRAVITY = 9.80665

# Specific heat of dry air at constant pressure (J kg-1 K-1)
SPECIFIC_HEAT_DRY_AIR = 1004.0

# Stefan-Boltzmann constant (W m-2 K-4)
STEFAN_BOLTZMANN = 5.670374419e-8

# Molar masses (g mol-1) — used for MMR<->VMR conversion.
# Reference parity: radiation/radiation_gas.F90:43-57 (IGasMolarMass).
MOLAR_MASS_DRY_AIR = 28.970
GAS_MOLAR_MASS = {
    "h2o": 18.0152833,
    "co2": 44.011,
    "o3": 47.9982,
    "n2o": 44.013,
    "co": 28.0101,
    "ch4": 16.043,
    "o2": 31.9988,
    "cfc11": 137.3686,
    "cfc12": 120.914,
    "hcfc22": 86.469,
    "ccl4": 153.823,
    "no2": 46.0055,
}

# Avogadro constant (mol-1) and derived quantities used in column-density
# computation (molecules / cm^2), matching RRTMG conventions
# (reference: ifsrrtm/rrtm_prepare_gases.F90).
AVOGADRO = 6.02214076e23

# Gas indices — order of the gas mixing-ratio cube's last axis.
# Mirrors the reference's enumeration (radiation/radiation_gas.F90:26-39)
# so namelist-driven configs map 1:1.
GAS_NAMES = (
    "h2o", "co2", "o3", "n2o", "co", "ch4", "o2",
    "cfc11", "cfc12", "hcfc22", "ccl4", "no2",
)
NUM_GASES = len(GAS_NAMES)
GAS_INDEX = {name: i for i, name in enumerate(GAS_NAMES)}

# Spectral dimensions of the RRTMG-IFS gas-optics model
# (reference: ifsrrtm/parrrtm.F90, ifsrrtm/parsrtm.F90, yoerrtm/yoesrtm).
NG_LW = 140   # longwave g-points (reduced from 256)
NBANDS_LW = 16
NG_SW = 112   # shortwave g-points (reduced from 224)
NBANDS_SW = 14

# LW diffusivity factor (radiation_two_stream.F90 'LwDiffusivity')
LW_DIFFUSIVITY = 1.66
