"""SPARTACUS per-layer reflectance/transmittance, all levels at once.

The per-cell pipeline: Gamma assembly -> Pade matrix exponential
(adding-doubling form, solvers/matrix.py) -> reflectance/transmittance
solves, the Meador-Weaver two-stream fallback where a point is not
3D-treated, and the clear-layer selection, so the sequential adding
scans in solvers/spartacus_{sw,lw}.py consume finished R/T/(RD/TD/TDD
| SU/SD) histories. It runs one level at a time inside a lax.scan; a
level with no 3D-treated point skips the expm pipeline (lax.cond).

Reference parity: radiation_spartacus_sw.F90:708-830 (Gamma assembly
+ expm -> reftrans), radiation_matrix.F90:1222-1333 (block-triangular
expm sparsity), radiation_spartacus_lw.F90:636-712 (LW Gamma +
particular solution).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..solvers import two_stream as ts
from ..solvers.matrix import (add_eye_g, expm_reftrans_lw_g,
                              expm_reftrans_sw_g, mm_gu, mv_gu, solve_g,
                              solve_vec_g)

# Cap on od/mu0 entering the Gamma direct block. exp(-60) = 8.8e-27 —
# zero at f32 flux resolution — but an uncapped diagonal (od/mu0 can
# reach ~1e11 near the terminator; mu0 is clamped at 1e-10) drives the
# 1-norm-based squaring count in expm to its bound for the whole
# batch: masked lanes still pay each squaring's block products.
MAX_OD_OVER_MU0_3D = 60.0

LW_DIFFUSIVITY = 1.66


def _diag_g(x, nreg):
    """(nreg, *batch) vector -> diagonal matrices (nreg, nreg, *batch)."""
    zero = jnp.zeros_like(x[0])
    return jnp.stack([
        jnp.stack([x[i] if i == j else zero for j in range(nreg)], axis=0)
        for i in range(nreg)], axis=0)


def _zero_offdiag_clear(M, is_clear):
    """Zero all but the (0,0) entry where is_clear (broadcast batch)."""
    m = M.shape[0]
    rows = []
    for i in range(m):
        cols = []
        for j in range(m):
            if i == 0 and j == 0:
                cols.append(M[0, 0])
            else:
                cols.append(jnp.where(is_clear, 0.0, M[i, j]))
        rows.append(jnp.stack(cols, axis=0))
    return jnp.stack(rows, axis=0)


def _zero_cloudy_vec(x, is_clear):
    return jnp.concatenate(
        [x[:1]] + [jnp.where(is_clear, 0.0, x[i:i + 1])
                   for i in range(1, x.shape[0])], axis=0)


# =========================================================================
# Shortwave
# =========================================================================

def sw_gamma_expm(cfg, nreg, mu0, od_rg, ssa_rg, g_rg, trd, trf,
                  use3d):
    """Region-coupled SW reflectance/transmittance matrices.

    Inputs: od_rg/ssa_rg/g_rg (nreg, *batch); trd/trf (nreg, nreg,
    *batch-broadcastable); mu0 broadcastable against *batch; use3d
    (*batch). Region-0 od must already be capped at max_gas_od_3d.
    Returns 5 matrices (nreg, nreg, *batch). Reference :708-830.

    use3d: where False the caller discards this result in favour of
    the Meador-Weaver fallback, so Gamma is zeroed there (expm(0)=I),
    keeping the squaring count at the max over 3D-treated points only
    (mirrors the reference's ng3D prefix)."""
    dtype = od_rg.dtype
    one_over_mu0 = 1.0 / mu0
    gamma1, gamma2, gamma3 = ts.sw_gammas(mu0, ssa_rg, g_rg)

    n3 = 3 * nreg
    batch = od_rg.shape[1:]
    rows = [[jnp.zeros(batch, dtype) for _ in range(n3)]
            for _ in range(n3)]

    def add(i, j, val):
        rows[i][j] = rows[i][j] + val

    for r in range(nreg):
        add(r, r, od_rg[r] * gamma1[r])
        add(nreg + r, r, od_rg[r] * gamma2[r])
        add(r, 2 * nreg + r, -od_rg[r] * ssa_rg[r] * gamma3[r])
        add(nreg + r, 2 * nreg + r,
            od_rg[r] * ssa_rg[r] * (1.0 - gamma3[r]))
        add(2 * nreg + r, 2 * nreg + r,
            -jnp.minimum(od_rg[r] * one_over_mu0, MAX_OD_OVER_MU0_3D))
    for r in range(nreg - 1):
        add(r, r, trf[r, r + 1])
        add(r + 1, r + 1, trf[r + 1, r])
        add(r + 1, r, -trf[r, r + 1])
        add(r, r + 1, -trf[r + 1, r])
        add(2 * nreg + r, 2 * nreg + r, -trd[r, r + 1])
        add(2 * nreg + r + 1, 2 * nreg + r + 1, -trd[r + 1, r])
        add(2 * nreg + r + 1, 2 * nreg + r, trd[r, r + 1])
        add(2 * nreg + r, 2 * nreg + r + 1, trd[r + 1, r])
    if nreg == 3:
        add(0, 0, trf[0, 2])
        add(2, 2, trf[2, 0])
        add(2, 0, -trf[0, 2])
        add(0, 2, -trf[2, 0])
        add(2 * nreg, 2 * nreg, -trd[0, 2])
        add(2 * nreg + 2, 2 * nreg + 2, -trd[2, 0])
        add(2 * nreg + 2, 2 * nreg, trd[0, 2])
        add(2 * nreg, 2 * nreg + 2, trd[2, 0])
    # antisymmetric blocks
    for i in range(nreg):
        for j in range(nreg):
            rows[nreg + i][nreg + j] = -rows[i][j]
            rows[i][nreg + j] = -rows[nreg + i][j]
    # Gamma is block-upper-triangular [[M, C], [0, D]]: exponentiate
    # blockwise (matrix.py expm_sw_g; the reference's expm_opt).
    n2 = 2 * nreg
    Gm = jnp.stack([jnp.stack(rows[i][:n2], axis=0) for i in range(n2)],
                   axis=0)
    Gc = jnp.stack([jnp.stack(rows[i][n2:], axis=0) for i in range(n2)],
                   axis=0)
    Gd = jnp.stack([jnp.stack(rows[n2 + i][n2:], axis=0)
                    for i in range(nreg)], axis=0)
    if use3d is not None:
        Gm = jnp.where(use3d, Gm, 0.0)
        Gc = jnp.where(use3d, Gc, 0.0)
        Gd = jnp.where(use3d, Gd, 0.0)

    # Adding-doubling (matrix.py expm_reftrans_sw_g) instead of the
    # -A^-1 B extraction on the full-layer exponential — same
    # conditioning rationale as the LW path (see lw_gamma_expm): that
    # extraction amplifies transcendental / reduction-order ULP
    # differences by ~e^{2||G||}.
    R, T, Rdir, Tdir, Tdd = expm_reftrans_sw_g(Gm, Gc, Gd)
    ref = jnp.clip(R, 0.0, 1.0)
    trans = jnp.clip(T, 0.0, 1.0)
    refdir = jnp.clip(Rdir, 0.0, mu0)
    tdiff = jnp.clip(Tdir, 0.0, mu0)
    tdd = jnp.clip(Tdd, 0.0, 1.0)
    return ref, trans, refdir, tdiff, tdd


def _sw_mw_diag(nreg, mu0, od, ssa, g):
    """Meador-Weaver fallback as diagonal region matrices."""
    g1, g2, g3 = ts.sw_gammas(mu0, ssa, g)
    rmw, tmw, rdmw, tdmw, tddmw = ts.sw_reftrans(mu0, od, ssa, g1, g2, g3)
    return tuple(_diag_g(x, nreg) for x in (rmw, tmw, rdmw, tdmw, tddmw))


def _sw_compute(cfg, nreg, od, ssa, gg, trd, trf, mu0, use3d, clear):
    """SW per-cell pipeline, batch-generic: od/ssa/gg (nreg, *batch);
    trd/trf (nreg, nreg, *bcast); mu0/clear *bcast; use3d (*batch)
    bool. Returns (R, T, RD, TD, TDD), each (nreg, nreg, *batch)."""
    od_capped = jnp.concatenate(
        [jnp.minimum(od[:1], cfg.max_gas_od_3d), od[1:]], axis=0)

    mw = _sw_mw_diag(nreg, mu0, od, ssa, gg)

    def full(_):
        f3 = sw_gamma_expm(cfg, nreg, mu0, od_capped, ssa, gg, trd,
                           trf, use3d)
        return tuple(jnp.where(use3d, a, b) for a, b in zip(f3, mw))

    def skip(_):
        return tuple(jnp.broadcast_to(M, (nreg, nreg) + use3d.shape)
                     for M in mw)

    # a level with no 3D point skips the whole expm pipeline
    out5 = jax.lax.cond(jnp.any(use3d), full, skip, None)
    return tuple(_zero_offdiag_clear(M, clear) for M in out5)


def sw_reftrans_levels(cfg, nreg, od_r, ssa_r, g_r, trd_g, trf_g, mu0,
                       use3d_g, clear_g):
    """All-levels SW reflectance/transmittance histories.

    od_r/ssa_r/g_r: (nlev, nreg, ng, ncol) (od region 0 uncapped —
    capping for the Gamma path happens inside); trd_g/trf_g: (nlev,
    nreg, nreg, 1, ncol); mu0 (ncol,); use3d_g (nlev, ng, ncol) bool;
    clear_g (nlev, ncol) bool. Returns (R, T, RD, TD, TDD) each
    (nlev, nreg, nreg, ng, ncol). One level at a time inside a scan,
    which keeps memory bounded."""
    def body(_, xs):
        od_l, ssa_l, g_l, trd_l, trf_l, u3_l, cl_l = xs
        return None, _sw_compute(cfg, nreg, od_l, ssa_l, g_l, trd_l,
                                 trf_l, mu0, u3_l, cl_l)

    _, hist = jax.lax.scan(
        body, None, (od_r, ssa_r, g_r, trd_g, trf_g, use3d_g, clear_g))
    return hist


# =========================================================================
# Longwave
# =========================================================================

def lw_gamma_expm(cfg, nreg, od_capped, ssa, gg, tr, se, pt, pb, fr,
                  use3d):
    """LW 3D reflectance/transmittance/source terms
    (radiation_spartacus_lw.F90:636-712), batch-generic."""
    dtype = od_capped.dtype
    n2 = 2 * nreg
    gamma1, gamma2 = ts.lw_gammas(ssa, gg)
    batch = od_capped.shape[1:]
    rows = [[jnp.zeros(batch, dtype) for _ in range(n2)]
            for _ in range(n2)]

    def add(i, j, val):
        rows[i][j] = rows[i][j] + val

    for r in range(nreg):
        add(r, r, od_capped[r] * gamma1[r])
        add(nreg + r, r, od_capped[r] * gamma2[r])
    for r in range(nreg - 1):
        add(r, r, tr[r, r + 1])
        add(r + 1, r, -tr[r, r + 1])
        if r > 0:
            add(r + 1, r + 1, tr[r + 1, r])
            add(r, r + 1, -tr[r + 1, r])
        else:
            add(r + 1, r + 1, se * tr[r + 1, r])
            add(r, r + 1, -se * tr[r + 1, r])
    if nreg == 3:
        add(0, 0, tr[0, 2])
        add(2, 0, -tr[0, 2])
        add(2, 2, se * tr[2, 0])
        add(0, 2, -se * tr[2, 0])
    # Gamma = [[Atl, -Bbl], [Bbl, -Atl]]; only the two independent
    # blocks are materialized — the particular solution exploits the
    # structure with nreg-sized solves
    Atl = jnp.stack([jnp.stack(rows[i][:nreg], axis=0)
                     for i in range(nreg)], axis=0)
    Bbl = jnp.stack([jnp.stack(rows[nreg + i][:nreg], axis=0)
                     for i in range(nreg)], axis=0)
    Atl = jnp.where(use3d, Atl, 0.0)
    Bbl = jnp.where(use3d, Bbl, 0.0)

    emis_coeff = jnp.where(use3d,
                           od_capped * (1.0 - ssa) * fr
                           * LW_DIFFUSIVITY, 0.0)
    # In the sum/difference basis the 2*nreg particular-solution solves
    # collapse to nreg x nreg solves:
    #   G [x; x'] = [-v; v]   ->  x = x' = -(A-B)^-1 v
    #   G [y; y'] = [u+w; u-w] -> y,y' = (A-B)^-1 w +/- (A+B)^-1 u
    # with v = emis*(P_bot - P_top), w = emis*P_top (ref :674-680).
    v = emis_coeff * (pb - pt)[None]
    w = emis_coeff * pt[None]

    Ereg = add_eye_g(Atl + Bbl, 1e-12)
    Freg = add_eye_g(Atl - Bbl, 1e-12)
    u = solve_vec_g(Freg, v)
    fw = solve_vec_g(Freg, w)
    eu = solve_vec_g(Ereg, u)
    sol0_up = fw + eu
    sol0_dn = fw - eu

    # Reflectance/transmittance by adding-doubling (matrix.py
    # expm_reftrans_lw_g), NOT by -A^-1 B extraction on the full-layer
    # exponential: cond(A) ~ e^{2 od gamma} makes that extraction lose
    # ~e^50 at the od caps — the round-4 root cause of the 5-10 W/m2
    # f32 lw_dn error at cloudy columns (it is marginal even in f64,
    # where the reference runs it; radiation_spartacus_lw.F90:694).
    ref3, trans3 = expm_reftrans_lw_g(Atl, Bbl)
    # Sources from the particular-solution boundary values and the
    # STABLE (R, T): subtracting the particular solution reduces the
    # layer to the homogeneous system, so (ref :694-712, re-derived)
    #   S_up = p_up(top) - R p_dn(top) - T p_up(bot)
    #   S_dn = p_dn(bot) - T p_dn(top) - R p_up(bot)
    # with p_up/dn(top) = sol0_up/dn and p_up/dn(bot) = sol0_up/dn + u
    # (u is the linear-in-z slope). Matches the old A^-1-based
    # formulas to 2e-12 in f64 at moderate od.
    pu_b = sol0_up + u
    sup3 = sol0_up - mv_gu(ref3, sol0_dn) - mv_gu(trans3, pu_b)
    sdn3 = sol0_dn + u - mv_gu(trans3, sol0_dn) - mv_gu(ref3, pu_b)
    return ref3, trans3, sup3, sdn3


def _lw_compute(cfg, nreg, od, ssa, gg, tr, se, pt, pb, fr, use3d,
                clear):
    """LW per-cell pipeline, batch-generic: od/ssa/gg (nreg, *batch);
    tr (nreg, nreg, *bcast); se/pt/pb (*batch); fr (nreg, *bcast);
    use3d (*batch) bool; clear *bcast bool. Returns (R, T, SU, SD):
    (nreg, nreg, *batch) matrices and (nreg, *batch) vectors."""
    od_capped = jnp.concatenate(
        [jnp.minimum(od[:1], cfg.max_gas_od_3d), od[1:]], axis=0)
    gamma1, gamma2 = ts.lw_gammas(ssa, gg)
    batch = od.shape[1:]

    def full(_):
        return lw_gamma_expm(cfg, nreg, od_capped, ssa, gg, tr, se,
                             pt, pb, fr, use3d)

    def skip(_):
        zm = jnp.zeros((nreg, nreg) + batch, od.dtype)
        zv = jnp.zeros((nreg,) + batch, od.dtype)
        return zm, zm, zv, zv

    ref3, trans3, sup3, sdn3 = jax.lax.cond(jnp.any(use3d), full, skip,
                                            None)

    pt_b = pt[None]
    pb_b = pb[None]
    if cfg.do_lw_cloud_scattering:
        rmw, tmw, sumw, sdmw = ts.lw_reftrans(
            od, gamma1, gamma2, pt_b * jnp.ones_like(od),
            pb_b * jnp.ones_like(od))
    else:
        tmw, sumw, sdmw = ts.lw_no_scattering_transmittance(
            od, pt_b * jnp.ones_like(od), pb_b * jnp.ones_like(od))
        rmw = jnp.zeros_like(tmw)
    sumw = sumw * fr
    sdmw = sdmw * fr

    ref = jnp.where(use3d, ref3, _diag_g(rmw, nreg))
    trans = jnp.where(use3d, trans3, _diag_g(tmw, nreg))
    sup = jnp.where(use3d, sup3, jnp.broadcast_to(sumw, (nreg,) + batch))
    sdn = jnp.where(use3d, sdn3, jnp.broadcast_to(sdmw, (nreg,) + batch))
    return (_zero_offdiag_clear(ref, clear),
            _zero_offdiag_clear(trans, clear),
            _zero_cloudy_vec(sup, clear), _zero_cloudy_vec(sdn, clear))


def lw_reftrans_levels(cfg, nreg, od_r, ssa_r, g_r, tr_g, se_g, pt_g,
                       pb_g, fr_g, use3d_g, clear_g):
    """All-levels LW histories (R, T, SU, SD), one level at a time
    inside a scan.

    od_r/ssa_r/g_r (nlev, nreg, ng, ncol); tr_g (nlev, nreg, nreg, 1,
    ncol); se_g/pt_g/pb_g (nlev, ng, ncol); fr_g (nlev, nreg, 1,
    ncol); use3d_g (nlev, ng, ncol); clear_g (nlev, ncol)."""
    def body(_, xs):
        return None, _lw_compute(cfg, nreg, *xs)

    _, hist = jax.lax.scan(
        body, None, (od_r, ssa_r, g_r, tr_g, se_g, pt_g, pb_g, fr_g,
                     use3d_g, clear_g))
    return hist
