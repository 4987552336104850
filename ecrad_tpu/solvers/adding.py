"""Adding method for independent-column radiative transfer.

Reference parity: radiation/radiation_adding_ica_sw.F90:24-147 and
radiation_adding_ica_lw.F90:32-324. The reference's three sequential
level loops (direct-beam descent, albedo/source ascent, flux descent) are
first-order linear (or Moebius) recurrences. Two implementations:

- `method='sequential'` (default): `jax.lax.scan` over levels carrying an
  (ng, ncol) state, the reference's own recurrence. With gfirst=True on
  a GPU the sweeps of one solve run instead as one Pallas (Triton)
  kernel (ops/adding_gpu.py); the `_*_sequential` scans here are its
  reference.
- `method='scan'`: `jax.lax.associative_scan` (parallel prefix over 2x2
  Moebius / affine transfer operators). O(log nlev) depth but ~2.5x more
  memory traffic; kept as an independent cross-check of the
  recurrences (see tests/test_adding.py).

All arrays are (..., nlev[+1], ng)-shaped with the level axis at -2,
TOA first (ecRad orientation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _use_kernel(x) -> bool:
    """Whether the g-first sweeps over x (nlev, ng, ncol) run as the
    kernels of ops/adding_gpu.py: on a GPU, in float32, while flat
    offsets fit int32. Elsewhere the lax.scan forms below run."""
    from ..ops import adding_gpu
    return (jax.default_backend() == "gpu" and x.dtype == jnp.float32
            and adding_gpu.fits(*x.shape))


# ---------------------------------------------------------------------------
# scan primitives
# ---------------------------------------------------------------------------

def _affine_scan(a, b, x0, axis, reverse=False):
    """Solve x_{k+1} = a_k x_k + b_k with x_0 = x0 via associative scan.

    a, b: (..., n, ...) along `axis`. Returns x of size n+1 along axis
    (including x0 at the start). With reverse=True solves
    x_k = a_k x_{k+1} + b_k given x_n = x0, returning x with x0 at the end.
    """
    if reverse:
        a = jnp.flip(a, axis)
        b = jnp.flip(b, axis)

    def combine(lo, hi):
        a1, b1 = lo
        a2, b2 = hi
        return a2 * a1, a2 * b1 + b2

    acum, bcum = jax.lax.associative_scan(combine, (a, b), axis=axis)
    x0e = jnp.expand_dims(x0, axis) if x0.ndim == a.ndim - 1 else x0
    x_rest = acum * x0e + bcum
    x = jnp.concatenate([x0e, x_rest], axis=axis)
    if reverse:
        x = jnp.flip(x, axis)
    return x


def _moebius_scan_albedo(ref, trans, albedo_surf, axis):
    """Upward albedo recurrence A_j = R_j + T_j^2 A_{j+1}/(1 - A_{j+1} R_j)
    as a scan of 2x2 Moebius compositions.

    A_j = (m00 A_{j+1} + m01) / (m10 A_{j+1} + m11) with
    m = [[T^2 - R^2, R], [-R, 1]].
    Returns A with size n+1 along axis (A[n] = albedo_surf at the end).
    """
    # build per-layer Moebius matrices, ordered surface->TOA for the scan
    m00 = trans * trans - ref * ref
    m01 = ref
    m10 = -ref
    m11 = jnp.ones_like(ref)
    # scan from the surface upwards: flip so index 0 = deepest layer
    elems = tuple(jnp.flip(x, axis) for x in (m00, m01, m10, m11))

    def combine(lo, hi):
        # lo applied first (closer to surface), hi composes on top
        a00, a01, a10, a11 = lo
        b00, b01, b10, b11 = hi
        c00 = b00 * a00 + b01 * a10
        c01 = b00 * a01 + b01 * a11
        c10 = b10 * a00 + b11 * a10
        c11 = b10 * a01 + b11 * a11
        # normalize to keep entries O(1); Moebius transforms are
        # scale-invariant
        norm = jnp.maximum(jnp.abs(c11), 1e-12)
        return c00 / norm, c01 / norm, c10 / norm, c11 / norm

    c00, c01, c10, c11 = jax.lax.associative_scan(combine, elems, axis=axis)
    asurf = jnp.expand_dims(albedo_surf, axis)
    albedo = (c00 * asurf + c01) / (c10 * asurf + c11)
    albedo = jnp.flip(albedo, axis)  # back to TOA-first layer order
    # append surface albedo so result indexes half-levels (n+1)
    return jnp.concatenate([albedo, asurf], axis=axis)


# ---------------------------------------------------------------------------
# LW adding (radiation_adding_ica_lw.F90:32-131)
# ---------------------------------------------------------------------------

def adding_lw(reflectance, transmittance, source_up, source_dn,
              emission_surf, albedo_surf, method="sequential",
              gfirst=False):
    """Full LW adding with scattering.

    reflectance/transmittance/source_up/source_dn: (..., nlev, ng),
    emission_surf/albedo_surf: (..., ng).
    Returns (flux_up, flux_dn), each (..., nlev+1, ng).

    gfirst=True: layer inputs are ALREADY (nlev, ng, ncol) and boundary
    inputs (ng, ncol); fluxes return as (nlev+1, ng, ncol) — no layout
    conversion at all (the g-first internal form, see _to_gfirst).
    """
    axis = -2
    if method == "sequential":
        if gfirst and _use_kernel(reflectance):
            from ..ops import adding_gpu
            return adding_gpu.adding_lw(reflectance, transmittance,
                                        source_up, source_dn,
                                        emission_surf, albedo_surf)
        return _adding_lw_sequential(reflectance, transmittance, source_up,
                                     source_dn, emission_surf, albedo_surf,
                                     gfirst=gfirst)
    assert not gfirst, "gfirst supports the sequential method only"
    # 1) albedo of the atmosphere below each half-level
    albedo = _moebius_scan_albedo(reflectance, transmittance, albedo_surf,
                                  axis)
    alb_below = albedo[..., 1:, :]  # A_{j+1} per layer j
    inv_denom = 1.0 / (1.0 - alb_below * reflectance)
    # 2) upward source: s_j = beta_j + alpha_j s_{j+1}
    alpha = transmittance * inv_denom
    beta = source_up + transmittance * alb_below * source_dn * inv_denom
    source = _affine_scan(alpha, beta, emission_surf, axis, reverse=True)
    # 3) downward flux: fd_{j+1} = (T_j fd_j + R_j s_{j+1} + Sd_j) invd_j
    a_dn = transmittance * inv_denom
    b_dn = (reflectance * source[..., 1:, :] + source_dn) * inv_denom
    zero_top = jnp.zeros_like(emission_surf)
    flux_dn = _affine_scan(a_dn, b_dn, zero_top, axis)
    flux_up = albedo * flux_dn + source
    return flux_up, flux_dn


def _to_gfirst(v):
    """(..., nlev, ng) -> (nlev, ng, ...): per-level scan slices and
    carries are (ng, ncol), the column batch minor."""
    return jnp.moveaxis(v, (-2, -1), (0, 1))


def _from_gfirst(y):
    """(nlev, ng, ...) -> (..., nlev, ng)."""
    return jnp.moveaxis(y, (0, 1), (-2, -1))


def _gvec(x):
    """(..., ng) -> (ng, ...) for scan carries/inits."""
    return jnp.moveaxis(x, -1, 0)


def _adding_lw_sequential(ref, trans, src_up, src_dn, emission_surf,
                          albedo_surf, gfirst=False):
    """Two lax.scan sweeps (radiation_adding_ica_lw.F90:32-131)."""
    def up_body(carry, x):
        albedo_below, source_below = carry
        r, t, su, sd = x
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        albedo = r + t * t * albedo_below * inv_denom
        source = su + t * (source_below + albedo_below * sd) * inv_denom
        return (albedo, source), (albedo, source, inv_denom)

    if gfirst:
        xs = (ref, trans, src_up, src_dn)
        alb_surf_g, emis_g = albedo_surf, emission_surf
    else:
        xs = tuple(_to_gfirst(v) for v in (ref, trans, src_up, src_dn))
        alb_surf_g = _gvec(albedo_surf)
        emis_g = _gvec(emission_surf)
    # reverse=True sweeps surface->TOA over TOA-first xs; ys[i] is the
    # albedo/source below half-level i directly — no flip copies
    (_, _), (alb_t, src_t, inv_denom) = jax.lax.scan(
        up_body, (alb_surf_g, emis_g), xs, reverse=True)
    albedo = jnp.concatenate([alb_t, alb_surf_g[None]], axis=0)
    source = jnp.concatenate([src_t, emis_g[None]], axis=0)

    def dn_body(fd, x):
        t, r, sd, s_below, invd = x
        fd_next = (t * fd + r * s_below + sd) * invd
        return fd_next, fd_next

    xs2 = (xs[1], xs[0], xs[3], source[1:], inv_denom)
    zero = jnp.zeros_like(emis_g)
    _, fd_rest = jax.lax.scan(dn_body, zero, xs2)
    flux_dn = jnp.concatenate([zero[None], fd_rest], axis=0)
    flux_up = albedo * flux_dn + source
    if gfirst:
        return flux_up, flux_dn
    return _from_gfirst(flux_up), _from_gfirst(flux_dn)


def _affine_seq(a, b, x0, reverse=False, gfirst=False):
    """Sequential counterpart of _affine_scan (lax.scan over levels)."""
    if gfirst:
        a_s, b_s, x0_g = a, b, x0
    else:
        a_s = _to_gfirst(a)
        b_s = _to_gfirst(b)
        x0_g = _gvec(x0)

    def body(x, ab):
        ak, bk = ab
        x_next = ak * x + bk
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0_g, (a_s, b_s), reverse=reverse)
    if reverse:
        # x_k = a_k x_{k+1} + b_k; ys land TOA-first, x0 at the bottom
        x = jnp.concatenate([xs, x0_g[None]], axis=0)
    else:
        x = jnp.concatenate([x0_g[None], xs], axis=0)
    return x if gfirst else _from_gfirst(x)


def lw_no_scattering_fluxes(transmittance, source_up, source_dn,
                            emission_surf, albedo_surf,
                            method="sequential", gfirst=False):
    """No-scattering LW fluxes: down then up
    (radiation_adding_ica_lw.F90:272-324). gfirst as in adding_lw."""
    if method == "sequential":
        if gfirst and _use_kernel(transmittance):
            from ..ops import adding_gpu
            return adding_gpu.lw_no_scattering(transmittance, source_up,
                                               source_dn, emission_surf,
                                               albedo_surf)
        return _lw_no_scattering_sequential(
            transmittance, source_up, source_dn, emission_surf,
            albedo_surf, gfirst=gfirst)
    assert not gfirst, "gfirst supports the sequential method only"
    affine = lambda a, b, x0, reverse=False: _affine_scan(
        a, b, x0, -2, reverse=reverse)
    return _lw_no_scattering(affine, transmittance, source_up, source_dn,
                             emission_surf, albedo_surf, gfirst)


def _lw_no_scattering_sequential(transmittance, source_up, source_dn,
                                 emission_surf, albedo_surf, gfirst=False):
    """The lax.scan form of lw_no_scattering_fluxes."""
    affine = lambda a, b, x0, reverse=False: _affine_seq(
        a, b, x0, reverse=reverse, gfirst=gfirst)
    return _lw_no_scattering(affine, transmittance, source_up, source_dn,
                             emission_surf, albedo_surf, gfirst)


def _lw_no_scattering(affine, transmittance, source_up, source_dn,
                      emission_surf, albedo_surf, gfirst):
    zero = jnp.zeros_like(emission_surf)
    # down: fd_{j+1} = T_j fd_j + Sd_j
    flux_dn = affine(transmittance, source_dn, zero)
    # up from surface: fu_surf = emission + albedo*fd_surf;
    # fu_j = T_j fu_{j+1} + Su_j
    fd_surf = flux_dn[-1] if gfirst else flux_dn[..., -1, :]
    fu_surf = emission_surf + albedo_surf * fd_surf
    flux_up = affine(transmittance, source_up, fu_surf, reverse=True)
    return flux_up, flux_dn


# ---------------------------------------------------------------------------
# SW adding (radiation_adding_ica_sw.F90:24-147)
# ---------------------------------------------------------------------------

def adding_sw(reflectance, transmittance, ref_dir, trans_dir_diff,
              trans_dir_dir, incoming_toa, albedo_surf_diffuse,
              albedo_surf_direct, cos_sza, method="sequential",
              gfirst=False):
    """SW adding. All layer quantities (..., nlev, ng); incoming_toa and
    albedos (..., ng); cos_sza (...,) per-column.

    The direct 'flux' carried through the recurrences is the flux into a
    plane PERPENDICULAR to the sun; outputs multiply by cos_sza at the
    end like the reference. Returns (flux_up, flux_dn_diffuse,
    flux_dn_direct), each (..., nlev+1, ng).
    """
    axis = -2
    cs = jnp.asarray(cos_sza)[..., None]  # (..., 1) vs g axis
    zero = jnp.zeros_like(incoming_toa)
    if method == "sequential":
        if gfirst and _use_kernel(reflectance):
            from ..ops import adding_gpu
            return adding_gpu.adding_sw(
                reflectance, transmittance, ref_dir, trans_dir_diff,
                trans_dir_dir, incoming_toa, albedo_surf_diffuse,
                albedo_surf_direct, jnp.asarray(cos_sza).reshape(1, -1))
        return _adding_sw_sequential(
            reflectance, transmittance, ref_dir, trans_dir_diff,
            trans_dir_dir, incoming_toa, albedo_surf_diffuse,
            albedo_surf_direct, cs, gfirst=gfirst)
    assert not gfirst, "gfirst supports the sequential method only"
    # 1) direct beam descent: fdir_{j+1} = t_dir_j fdir_j
    flux_dn_direct = _affine_scan(trans_dir_dir,
                                  jnp.zeros_like(trans_dir_dir),
                                  incoming_toa, axis)
    # 2) albedo ascent
    albedo = _moebius_scan_albedo(reflectance, transmittance,
                                  albedo_surf_diffuse, axis)
    alb_below = albedo[..., 1:, :]
    inv_denom = 1.0 / (1.0 - alb_below * reflectance)
    # 3) source ascent: s_j = beta + alpha s_{j+1}
    fdir_top = flux_dn_direct[..., :-1, :]  # direct flux entering layer j
    alpha = transmittance * inv_denom
    beta = (ref_dir * fdir_top
            + transmittance * alb_below * trans_dir_diff * fdir_top
            * inv_denom)
    source_surf = albedo_surf_direct * flux_dn_direct[..., -1, :] * cs
    source = _affine_scan(alpha, beta, source_surf, axis, reverse=True)
    # 4) diffuse flux descent
    a_dn = transmittance * inv_denom
    b_dn = (reflectance * source[..., 1:, :]
            + trans_dir_diff * fdir_top) * inv_denom
    flux_dn_diffuse = _affine_scan(a_dn, b_dn, zero, axis)
    flux_up = albedo * flux_dn_diffuse + source
    flux_dn_direct = flux_dn_direct * cs[..., None, :]
    return flux_up, flux_dn_diffuse, flux_dn_direct


def _adding_sw_sequential(ref, trans, ref_dir, trans_dir_diff,
                          trans_dir_dir, incoming_toa, albedo_diffuse,
                          albedo_direct, cs, gfirst=False):
    """Three lax.scan sweeps, the reference's own loop structure
    (radiation_adding_ica_sw.F90:85-143). Internal layout is g-first
    (nlev, ng, ...) — see _to_gfirst."""
    if gfirst:
        inc_g = incoming_toa
        cs_g = jnp.asarray(cs).reshape(1, -1)   # (1, ncol)
    else:
        inc_g = _gvec(incoming_toa)
        cs_g = _gvec(cs)                        # (1, ...) vs (ng, ...)

    # 1) direct beam descent
    def dir_body(fd, tdd):
        fd_next = tdd * fd
        return fd_next, fd_next

    _, fdir_rest = jax.lax.scan(
        dir_body, inc_g,
        trans_dir_dir if gfirst else _to_gfirst(trans_dir_dir))
    flux_dn_direct = jnp.concatenate([inc_g[None], fdir_rest], 0)
    fdir_top = flux_dn_direct[:-1]              # entering each layer

    # 2) albedo & source ascent (reverse scan: surface->TOA, ys land
    # TOA-first with no flip copies)
    alb_diff_g = albedo_diffuse if gfirst else _gvec(albedo_diffuse)
    albdir_g = albedo_direct if gfirst else _gvec(albedo_direct)
    source_surf = albdir_g * flux_dn_direct[-1] * cs_g

    def up_body(carry, x):
        albedo_below, source_below = carry
        r, t, rd, tdd, fdt = x
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        albedo = r + t * t * albedo_below * inv_denom
        source = (rd * fdt
                  + t * (source_below + albedo_below * tdd * fdt)
                  * inv_denom)
        return (albedo, source), (albedo, source, inv_denom)

    if gfirst:
        xs = (ref, trans, ref_dir, trans_dir_diff, fdir_top)
    else:
        xs = (_to_gfirst(ref), _to_gfirst(trans), _to_gfirst(ref_dir),
              _to_gfirst(trans_dir_diff), fdir_top)
    (_, _), (alb_t, src_t, inv_denom) = jax.lax.scan(
        up_body, (alb_diff_g, source_surf), xs, reverse=True)
    albedo = jnp.concatenate([alb_t, alb_diff_g[None]], 0)
    source = jnp.concatenate([src_t, source_surf[None]], 0)

    # 3) diffuse flux descent
    def dn_body(fd, x):
        t, r, tdd, fdt, s_below, invd = x
        fd_next = (t * fd + r * s_below + tdd * fdt) * invd
        return fd_next, fd_next

    xs2 = (xs[1], xs[0], xs[3], fdir_top, source[1:], inv_denom)
    zero = jnp.zeros_like(inc_g)
    _, fd_rest = jax.lax.scan(dn_body, zero, xs2)
    flux_dn_diffuse = jnp.concatenate([zero[None], fd_rest], 0)
    flux_up = albedo * flux_dn_diffuse + source

    if gfirst:
        return flux_up, flux_dn_diffuse, flux_dn_direct * cs_g
    return (_from_gfirst(flux_up), _from_gfirst(flux_dn_diffuse),
            _from_gfirst(flux_dn_direct * cs_g))
