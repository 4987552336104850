"""Mapping of user albedo/emissivity intervals to spectral bands.

Reference parity: radiation/radiation_config.F90:1374-1560
(define_sw_albedo_intervals / consolidate_intervals) and
radiation_single_level.F90:204-330 (get_albedos). Intervals are defined by
monotonically increasing wavelength bounds (m); weights are the fractional
wavenumber overlap of each interval with each band. All computed at setup
time in numpy (static for jit).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def interval_mapping(wavelength_bound: Tuple[float, ...],
                     i_intervals: Tuple[int, ...],
                     wavenumber1: np.ndarray, wavenumber2: np.ndarray,
                     do_nearest: bool
                     ) -> Tuple[Optional[np.ndarray],
                                Optional[np.ndarray]]:
    """Returns (i_mapping, weights): nearest-neighbour band->interval map
    (0-based) or overlap weights (nvalue, nband); the unused one is None.
    """
    nband = len(wavenumber1)
    # count leading positive interval indices
    ninterval = 0
    for idx in i_intervals:
        if idx and idx > 0:
            ninterval += 1
        else:
            break
    if ninterval < 2:
        return np.zeros(nband, dtype=int), None

    bounds = np.asarray(wavelength_bound[:ninterval - 1], dtype=float)
    idxs = np.asarray(i_intervals[:ninterval], dtype=int)
    if not np.all(np.diff(bounds) > 0):
        raise ValueError("wavelength bounds must be increasing")
    nvalue = int(idxs.max())

    if do_nearest:
        mapping = np.zeros(nband, dtype=int)
        for jband in range(nband):
            wn_mid = 0.5 * (wavenumber1[jband] + wavenumber2[jband])
            iint = 0
            wn_bound = 0.01 / bounds[iint]
            while wn_bound >= wn_mid and iint < ninterval - 1:
                iint += 1
                wn_bound = 0.01 / bounds[iint] if iint < ninterval - 1 \
                    else 0.0
            mapping[jband] = idxs[iint] - 1
        return mapping, None

    weights = np.zeros((nvalue, nband))
    for jband in range(nband):
        recip_dwn = 1.0 / (wavenumber2[jband] - wavenumber1[jband])
        iint = 0
        wn1_alb = 0.01 / bounds[iint]
        while wn1_alb >= wavenumber2[jband] and iint < ninterval - 1:
            iint += 1
            wn1_alb = (0.01 / bounds[iint] if iint < ninterval - 1
                       else 0.0)
        wn2_alb = wavenumber2[jband]
        while wn2_alb > wavenumber1[jband] and iint <= ninterval - 1:
            weights[idxs[iint] - 1, jband] += recip_dwn * (
                min(wn2_alb, wavenumber2[jband])
                - max(wn1_alb, wavenumber1[jband]))
            wn2_alb = wn1_alb
            iint += 1
            if iint < ninterval - 1:
                wn1_alb = 0.01 / bounds[iint]
            else:
                wn1_alb = 0.0
    return None, weights


def expand_to_g(values: jnp.ndarray, mapping: Optional[np.ndarray],
                weights: Optional[np.ndarray],
                band_from_g: np.ndarray) -> jnp.ndarray:
    """Map user interval values (ncol, nintervals) to per-g (ncol, ng).

    Either nearest (mapping: band -> interval index) or weighted
    (weights: (nvalue, nband))."""
    if weights is not None:
        w = jnp.asarray(weights, values.dtype)  # (nvalue, nband)
        nvalue = w.shape[0]
        # HIGHEST: a reduced-precision default (bf16 or TF32 inputs)
        # rounds every surface albedo to ~3 decimal digits (~0.5 W/m2
        # on clear-sky sw_up)
        band_vals = jnp.matmul(values[:, :nvalue], w,
                               precision=jax.lax.Precision.HIGHEST)
    else:
        band_vals = values[:, mapping]      # (ncol, nband)
    return band_vals[:, band_from_g]
