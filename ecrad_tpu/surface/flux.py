"""Surface flux outputs at tile facets.

Reference parity: radsurf/radsurf_flux.F90 (surface_flux_type :27-49).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from ..pytree import pytree_dataclass


@pytree_dataclass
class SurfaceFlux:
    """Broadband fluxes into each facet of the surface (W m-2).

    Facet arrays are (ncol, nfacet); canopy absorption is (ncol, ntile).
    """
    lw_dn_facet: Optional[jnp.ndarray] = None
    lw_up_facet: Optional[jnp.ndarray] = None
    lw_abs_canopy: Optional[jnp.ndarray] = None
    sw_dn_facet: Optional[jnp.ndarray] = None
    sw_dn_direct_facet: Optional[jnp.ndarray] = None
    sw_up_facet: Optional[jnp.ndarray] = None
    sw_abs_canopy: Optional[jnp.ndarray] = None
