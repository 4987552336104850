"""An atmospheric radiation scheme in JAX.

A from-scratch JAX implementation with the capabilities of the ECMWF
ecRad radiation scheme (gas/cloud/aerosol optics + five radiative
transfer solvers). Columns shard over a device mesh, the spectral
(g-point) and column axes batch every operation, and the level
recurrences are scans (on a GPU, the adding sweeps are one Pallas
kernel per solve: ops/adding_gpu.py).
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    DriverConfig,
    Entrapment,
    GasModel,
    IceModel,
    LiquidModel,
    Overlap,
    PdfShape,
    RadiationConfig,
    Solver,
    load_config_from_namelist,
    load_driver_config_from_namelist,
)
from .types import (  # noqa: F401
    Aerosol,
    Cloud,
    Flux,
    GasConcs,
    SingleLevel,
    Thermodynamics,
)
