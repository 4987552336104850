"""Surface tile description: flat / homogeneous-vegetation / urban-3D tiles.

Reference parity: radsurf/radsurf_properties.F90 (surface_type :48-122,
tile codes :28-41, facet index assignment :223-271, NetCDF reader :389-443).

Design notes: the tile representation codes are *static* python
metadata (they select trace-time code paths, exactly as the reference's
`select case` picks at runtime per tile); all per-column physical fields
are dense jnp arrays with columns leading so the whole description shards
over the column mesh axis together with the atmosphere.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
from ..pytree import pytree_dataclass, static_field

# Tile representation codes (radsurf_properties.F90:28-32); 1-based to
# match the values stored in input files.
ITileFlat = 1
ITileVegetation = 2
ITileUrban3D = 3

TILE_NAMES = {ITileFlat: "Flat",
              ITileVegetation: "HomogeneousVegetation",
              ITileUrban3D: "Urban3D"}
# Facets and regions contributed by each tile type
# (radsurf_properties.F90:40-41).
N_TILE_FACETS = {ITileFlat: 1, ITileVegetation: 1, ITileUrban3D: 3}
N_TILE_REGIONS = {ITileFlat: 0, ITileVegetation: 1, ITileUrban3D: 1}


def facet_region_indices(representation: Tuple[int, ...]):
    """Assign facet/region indices per tile (radsurf_properties.F90:249-269).

    Returns (ground, roof, wall, region) dicts keyed by tile index; roof /
    wall / region entries are None for tiles without them. Indices are
    0-based.
    """
    ground, roof, wall, region = {}, {}, {}, {}
    ifacet = 0
    iregion = 0
    for jtile, rep in enumerate(representation):
        ground[jtile] = ifacet
        ifacet += 1
        roof[jtile] = wall[jtile] = region[jtile] = None
        if rep == ITileVegetation:
            region[jtile] = iregion
            iregion += 1
        elif rep == ITileUrban3D:
            roof[jtile] = ifacet
            wall[jtile] = ifacet + 1
            ifacet += 2
            region[jtile] = iregion
            iregion += 1
        elif rep != ITileFlat:
            raise ValueError(f"tile representation {rep} not understood")
    return ground, roof, wall, region


@pytree_dataclass
class SurfaceDescription:
    """Physical description of surface tiles (radsurf_properties.F90:48).

    Array shapes: skin_temperature (ncol, nfacet); sw_albedo /
    sw_albedo_direct (ncol, nfacet, nalbedobands); lw_emissivity
    (ncol, nfacet, nemissbands); all per-tile fields (ncol, ntile);
    vegetation_sw_albedo (ncol, ntile, nalbedobands);
    vegetation_lw_emissivity (ncol, ntile, nemissbands). (The reference
    stores the spectral dimension in the middle; here it is innermost so
    facets broadcast.)
    """
    skin_temperature: jnp.ndarray
    sw_albedo: jnp.ndarray
    lw_emissivity: jnp.ndarray
    sw_albedo_direct: Optional[jnp.ndarray] = None
    tile_fraction: Optional[jnp.ndarray] = None
    canopy_depth: Optional[jnp.ndarray] = None
    canopy_temperature: Optional[jnp.ndarray] = None
    building_fraction: Optional[jnp.ndarray] = None
    building_normalized_perimeter: Optional[jnp.ndarray] = None
    vegetation_optical_depth: Optional[jnp.ndarray] = None
    vegetation_fractional_std: Optional[jnp.ndarray] = None
    vegetation_sw_albedo: Optional[jnp.ndarray] = None
    vegetation_lw_emissivity: Optional[jnp.ndarray] = None
    # static metadata (selects trace-time code paths)
    representation: Tuple[int, ...] = static_field((ITileFlat,))

    @property
    def is_simple(self) -> bool:
        return self.representation == (ITileFlat,)

    @property
    def ntile(self) -> int:
        return len(self.representation)

    @property
    def nfacet(self) -> int:
        return sum(N_TILE_FACETS[r] for r in self.representation)

    @property
    def nregion(self) -> int:
        return sum(N_TILE_REGIONS[r] for r in self.representation)

    @property
    def ncol(self) -> int:
        return self.skin_temperature.shape[0]

    @property
    def nalbedobands(self) -> int:
        return self.sw_albedo.shape[2]

    @property
    def nemissbands(self) -> int:
        return self.lw_emissivity.shape[2]

    def indices(self):
        return facet_region_indices(self.representation)


def read_surface(path_or_file, dtype=jnp.float32) -> SurfaceDescription:
    """Read a tiled surface description from a driver input NetCDF file.

    Reference parity: radsurf_properties.F90:389-443 (read_from_netcdf),
    including the building_scale -> normalized-perimeter conversion
    (:425-429).
    """
    from ..io.netcdf import NetcdfFile
    close = False
    if isinstance(path_or_file, str):
        f = NetcdfFile(path_or_file)
        close = True
    else:
        f = path_or_file
    try:
        rep = tuple(int(v) for v in np.atleast_1d(f.read(
            "tile_representation")))
        skin_t = np.atleast_2d(f.read("skin_temperature"))
        sw_albedo = f.read("sw_albedo")          # (ncol, nfacet, nband)
        lw_emissivity = f.read("lw_emissivity")
        if sw_albedo.ndim == 2:                  # (ncol, nfacet): one band
            sw_albedo = sw_albedo[:, :, None]
        if lw_emissivity.ndim == 2:
            lw_emissivity = lw_emissivity[:, :, None]
        sw_albedo_direct = None
        if f.exists("sw_albedo_direct"):
            sw_albedo_direct = f.read("sw_albedo_direct")
            if sw_albedo_direct.ndim == 2:
                sw_albedo_direct = sw_albedo_direct[:, :, None]

        def opt2d(name):
            if f.exists(name):
                return jnp.asarray(np.atleast_2d(f.read(name)), dtype)
            return None

        bf = opt2d("building_fraction")
        if f.exists("building_normalized_perimeter"):
            bnp_ = opt2d("building_normalized_perimeter")
        elif f.exists("building_scale") and bf is not None:
            scale = np.atleast_2d(f.read("building_scale"))
            bnp_ = jnp.asarray(
                4.0 * np.asarray(bf) * (1.0 - np.asarray(bf))
                / np.maximum(1.0e-8, scale), dtype)
        else:
            bnp_ = None

        def opt3d(name):
            if f.exists(name):
                v = f.read(name)
                if v.ndim == 2:
                    v = v[:, :, None]
                return jnp.asarray(v, dtype)
            return None

        return SurfaceDescription(
            skin_temperature=jnp.asarray(skin_t, dtype),
            sw_albedo=jnp.asarray(sw_albedo, dtype),
            lw_emissivity=jnp.asarray(lw_emissivity, dtype),
            sw_albedo_direct=(jnp.asarray(sw_albedo_direct, dtype)
                              if sw_albedo_direct is not None else None),
            tile_fraction=opt2d("tile_fraction"),
            canopy_depth=opt2d("canopy_depth"),
            canopy_temperature=opt2d("canopy_temperature"),
            building_fraction=bf,
            building_normalized_perimeter=bnp_,
            vegetation_optical_depth=opt2d("vegetation_optical_depth"),
            vegetation_fractional_std=opt2d("vegetation_fractional_std"),
            vegetation_sw_albedo=opt3d("vegetation_sw_albedo"),
            vegetation_lw_emissivity=opt3d("vegetation_lw_emissivity"),
            representation=rep,
        )
    finally:
        if close:
            f.close()


def input_has_tiled_surface(path: str) -> bool:
    """True if the driver input file carries a complex surface description
    (driver/ecrad_driver_read_input.F90 detects via tile variables)."""
    from ..io.netcdf import NetcdfFile
    with NetcdfFile(path) as f:
        return f.exists("tile_representation") and f.exists("tile_fraction")


def print_surface_representation(representation: Tuple[int, ...]) -> str:
    """Human-readable tile/facet/region listing
    (radsurf_properties.F90:347-385)."""
    lines = ["Surface tile representation:"]
    if representation == (ITileFlat,):
        lines.append("  Simple (one flat tile)")
    else:
        ifacet, iregion = 1, 1
        for jtile, rep in enumerate(representation, start=1):
            lines.append(f"  Tile {jtile}: {TILE_NAMES[rep]}")
            lines.append(f"    Facet {ifacet}: ground")
            ifacet += 1
            if rep == ITileVegetation:
                lines.append(f"    Region {iregion}: vegetation canopy")
                iregion += 1
            elif rep == ITileUrban3D:
                lines.append(f"    Facet {ifacet}: roof")
                lines.append(f"    Facet {ifacet + 1}: wall")
                ifacet += 2
                lines.append(f"    Region {iregion}: street canyon")
                iregion += 1
    return "\n".join(lines)
