"""ICA adding sweeps as one Pallas kernel per solve (Triton route, GPU).

The adding method (solvers/adding.py) runs two or three level
recurrences over ~137 levels for every (g-point, column) lane. Under
XLA each is a `lax.scan`, i.e. a device while loop: one step per level,
each step its own kernel launches, the carry and the per-level outputs
going through device memory, and the next sweep reading them back.

Here one program owns BLOCK lanes of the flattened (g, column) plane and
loops over all levels inside the kernel with the carry in registers.
All sweeps of a solve run in the same program, so what the upward sweep
writes (albedo and source below each half level) is read back only by
that program's downward sweep. Those two intermediates are parked in the
output buffers the downward sweep overwrites (the diffuse-down buffer
holds the albedo, the up buffer the source), so the kernel needs no
scratch memory. Levels are indexed inside the loop (137 is not a
power of two, so it cannot be a Triton block dimension).

Every array is g-first (nlev[+1], ng, ncol), the layout of
solvers/adding.py with gfirst=True, and flattened to 1-D: the element
of level l and lane i sits at l * n + i with n = ng * ncol. The
`lax.scan` forms in solvers/adding.py are the reference: the kernels
evaluate the same expressions in the same order, and
tests/test_adding_gpu.py checks them against it in interpret mode.

Reference parity: radiation_adding_ica_sw.F90:24-147 and
radiation_adding_ica_lw.F90:32-131, :272-324.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 512        # lanes per program: 4 warps x 32 threads x 4 lanes
NUM_WARPS = 4


def fits(nlev: int, ng: int, ncol: int) -> bool:
    """Flat element offsets of the (nlev+1, ng, ncol) outputs fit int32."""
    return (nlev + 1) * ng * ncol + BLOCK < 2 ** 31


def _lanes(n):
    lane = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    mask = lane < n

    def ld(ref, lev=0):
        return plgpu.load(ref.at[lev * n + lane], mask=mask, other=0.0)

    def st(ref, lev, val):
        plgpu.store(ref.at[lev * n + lane], val, mask=mask)

    return ld, st


def _sw_kernel(r_ref, t_ref, rdir_ref, tdif_ref, tdir_ref, inc_ref,
               adif_ref, adir_ref, mu0_ref, up_ref, dn_ref, dir_ref, *,
               n, nlev):
    ld, st = _lanes(n)

    # 1) direct beam descent; dir_ref[l] holds the flux entering layer l
    def down_direct(lev, fdir):
        st(dir_ref, lev, fdir)
        return ld(tdir_ref, lev) * fdir

    fdir_surf = lax.fori_loop(0, nlev, down_direct, ld(inc_ref))
    mu0 = ld(mu0_ref)

    # 2) albedo (parked in dn_ref) and source (in up_ref) below each
    # half level, surface to TOA
    albedo = ld(adif_ref)
    source = ld(adir_ref) * fdir_surf * mu0
    st(dn_ref, nlev, albedo)
    st(up_ref, nlev, source)

    def up(i, carry):
        albedo_below, source_below = carry
        lev = nlev - 1 - i
        r, t = ld(r_ref, lev), ld(t_ref, lev)
        fdt = ld(dir_ref, lev)
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        albedo = r + t * t * albedo_below * inv_denom
        source = (ld(rdir_ref, lev) * fdt
                  + t * (source_below + albedo_below * ld(tdif_ref, lev)
                         * fdt) * inv_denom)
        st(dn_ref, lev, albedo)
        st(up_ref, lev, source)
        return albedo, source

    lax.fori_loop(0, nlev, up, (albedo, source))

    # 3) diffuse descent; up at TOA is the source there, already in place
    zero = jnp.zeros_like(mu0)
    st(dn_ref, 0, zero)

    def down_diffuse(lev, fd):
        r, t = ld(r_ref, lev), ld(t_ref, lev)
        fdt = ld(dir_ref, lev)
        source_below = ld(up_ref, lev + 1)
        albedo_below = ld(dn_ref, lev + 1)
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        fd = (t * fd + r * source_below + ld(tdif_ref, lev) * fdt) \
            * inv_denom
        st(dn_ref, lev + 1, fd)
        st(up_ref, lev + 1, albedo_below * fd + source_below)
        st(dir_ref, lev, fdt * mu0)
        return fd

    lax.fori_loop(0, nlev, down_diffuse, zero)
    st(dir_ref, nlev, fdir_surf * mu0)


def _lw_kernel(r_ref, t_ref, su_ref, sd_ref, emis_ref, alb_ref, up_ref,
               dn_ref, *, n, nlev):
    ld, st = _lanes(n)

    # 1) albedo (parked in dn_ref) and source (in up_ref), surface to TOA
    albedo, source = ld(alb_ref), ld(emis_ref)
    st(dn_ref, nlev, albedo)
    st(up_ref, nlev, source)

    def up(i, carry):
        albedo_below, source_below = carry
        lev = nlev - 1 - i
        r, t = ld(r_ref, lev), ld(t_ref, lev)
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        albedo = r + t * t * albedo_below * inv_denom
        source = ld(su_ref, lev) + t * (
            source_below + albedo_below * ld(sd_ref, lev)) * inv_denom
        st(dn_ref, lev, albedo)
        st(up_ref, lev, source)
        return albedo, source

    lax.fori_loop(0, nlev, up, (albedo, source))

    # 2) downward flux
    zero = jnp.zeros_like(albedo)
    st(dn_ref, 0, zero)

    def down(lev, fd):
        r, t = ld(r_ref, lev), ld(t_ref, lev)
        source_below = ld(up_ref, lev + 1)
        albedo_below = ld(dn_ref, lev + 1)
        inv_denom = 1.0 / (1.0 - albedo_below * r)
        fd = (t * fd + r * source_below + ld(sd_ref, lev)) * inv_denom
        st(dn_ref, lev + 1, fd)
        st(up_ref, lev + 1, albedo_below * fd + source_below)
        return fd

    lax.fori_loop(0, nlev, down, zero)


def _lw_noscat_kernel(t_ref, su_ref, sd_ref, emis_ref, alb_ref, up_ref,
                      dn_ref, *, n, nlev):
    ld, st = _lanes(n)
    zero = jnp.zeros_like(ld(emis_ref))
    st(dn_ref, 0, zero)

    def down(lev, fd):
        fd = ld(t_ref, lev) * fd + ld(sd_ref, lev)
        st(dn_ref, lev + 1, fd)
        return fd

    fd_surf = lax.fori_loop(0, nlev, down, zero)
    fu = ld(emis_ref) + ld(alb_ref) * fd_surf
    st(up_ref, nlev, fu)

    def up(i, fu):
        lev = nlev - 1 - i
        fu = ld(t_ref, lev) * fu + ld(su_ref, lev)
        st(up_ref, lev, fu)
        return fu

    lax.fori_loop(0, nlev, up, fu)


def _run(kernel, name, layers, bounds, n_out, interpret):
    """layers: (nlev, ng, ncol) arrays; bounds: (ng, ncol) arrays.
    Returns n_out (nlev+1, ng, ncol) arrays."""
    nlev, ng, ncol = layers[0].shape
    n = ng * ncol
    dtype = layers[0].dtype
    out = pl.pallas_call(
        functools.partial(kernel, n=n, nlev=nlev),
        out_shape=[jax.ShapeDtypeStruct(((nlev + 1) * n,), dtype)] * n_out,
        grid=(pl.cdiv(n, BLOCK),),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*[x.reshape(-1) for x in layers],
      *[jnp.broadcast_to(b, (ng, ncol)).astype(dtype).reshape(-1)
        for b in bounds])
    return [o.reshape(nlev + 1, ng, ncol) for o in out]


def adding_sw(ref, trans, ref_dir, trans_dir_diff, trans_dir_dir,
              incoming_toa, albedo_diffuse, albedo_direct, mu0,
              interpret=False):
    """SW adding, g-first: layers (nlev, ng, ncol); incoming_toa and the
    albedos (ng, ncol); mu0 (1, ncol). Returns (flux_up,
    flux_dn_diffuse, flux_dn_direct), each (nlev+1, ng, ncol); the
    direct flux is into a horizontal plane (times mu0)."""
    up, dn, direct = _run(
        _sw_kernel, "adding_sw",
        (ref, trans, ref_dir, trans_dir_diff, trans_dir_dir),
        (incoming_toa, albedo_diffuse, albedo_direct, mu0), 3, interpret)
    return up, dn, direct


def adding_lw(ref, trans, source_up, source_dn, emission_surf,
              albedo_surf, interpret=False):
    """LW adding with scattering, g-first. Returns (flux_up, flux_dn)."""
    up, dn = _run(_lw_kernel, "adding_lw",
                  (ref, trans, source_up, source_dn),
                  (emission_surf, albedo_surf), 2, interpret)
    return up, dn


def lw_no_scattering(trans, source_up, source_dn, emission_surf,
                     albedo_surf, interpret=False):
    """LW fluxes without scattering (down then up), g-first."""
    up, dn = _run(_lw_noscat_kernel, "lw_no_scattering",
                  (trans, source_up, source_dn),
                  (emission_surf, albedo_surf), 2, interpret)
    return up, dn
