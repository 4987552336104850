"""Tile a small column set into a large batch with seeded perturbations.

`tile_columns(inputs, copies, seed)` repeats every column `copies` times
(copy-major: column j of copy k lands at k * ncol + j). Copy 0 is the
input unchanged; every later copy gets its own per-column perturbation,
drawn from `numpy.random.default_rng(seed)`, of the state the clear-sky
path sees:

- temperature profile and skin temperature shifted by U(-5, 5) K,
- water vapour scaled by U(0.8, 1.2) and ozone by U(0.9, 1.1),
- cosine of the solar zenith angle shifted by U(-0.2, 0.2), in [-1, 1],
- surface albedos scaled by U(0.9, 1.1), in [0, 1].

Pressure, the well-mixed gases, clouds and aerosols are repeated as they
are. The same (inputs, copies, seed) always gives the same batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GAS_INDEX


def _repeat(x, copies):
    x = np.asarray(x)
    return np.tile(x, (copies,) + (1,) * (x.ndim - 1))


def tile_columns(inputs, copies: int, seed: int = 0):
    """(single_level, thermodynamics, gas, cloud, aerosol) with ncol
    columns -> the same five with copies * ncol columns."""
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    single_level, thermo, gas, cloud, aerosol = inputs
    ncol = single_level.ncol
    rng = np.random.default_rng(seed)

    def draw(lo, hi, identity):
        """(copies * ncol,) per-column values; copy 0 gets `identity`."""
        v = rng.uniform(lo, hi, (copies, ncol))
        v[0] = identity
        return v.reshape(-1)

    d_temp = draw(-5.0, 5.0, 0.0)
    s_h2o = draw(0.8, 1.2, 1.0)
    s_o3 = draw(0.9, 1.1, 1.0)
    d_mu0 = draw(-0.2, 0.2, 0.0)
    s_alb = draw(0.9, 1.1, 1.0)

    def tiled(tree):
        """Repeat every per-column array of a pytree (leading axis ncol)."""
        return jax.tree.map(
            lambda x: (_repeat(x, copies)
                       if np.ndim(x) > 0 and np.shape(x)[0] == ncol else x),
            tree)

    sl = tiled(single_level)
    f32 = np.float32
    cos_sza = np.clip(sl.cos_sza + d_mu0, -1.0, 1.0).astype(f32)
    sw_albedo = np.clip(sl.sw_albedo * s_alb[:, None], 0.0, 1.0).astype(f32)
    sw_albedo_direct = (None if sl.sw_albedo_direct is None else np.clip(
        sl.sw_albedo_direct * s_alb[:, None], 0.0, 1.0).astype(f32))
    iseed = None
    if sl.iseed is not None:
        # distinct seeds per column of every copy
        iseed = (np.asarray(sl.iseed).reshape(copies, ncol)
                 + ncol * np.arange(copies)[:, None]).reshape(-1)
    sl = sl.replace(
        cos_sza=cos_sza,
        skin_temperature=(sl.skin_temperature + d_temp).astype(f32),
        sw_albedo=sw_albedo, sw_albedo_direct=sw_albedo_direct,
        iseed=iseed)

    th = tiled(thermo)
    th = th.replace(
        temperature_hl=(th.temperature_hl + d_temp[:, None]).astype(f32))

    g = tiled(gas)
    mmr = np.array(g.mixing_ratio)
    mmr[:, :, GAS_INDEX["h2o"]] *= s_h2o[:, None]
    mmr[:, :, GAS_INDEX["o3"]] *= s_o3[:, None]
    g = g.replace(mixing_ratio=mmr.astype(f32))

    out = (sl, th, g, tiled(cloud), tiled(aerosol))
    return jax.tree.map(jnp.asarray, out)
