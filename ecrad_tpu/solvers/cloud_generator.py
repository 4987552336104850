"""Stochastic cloud generator for McICA, fully vectorized.

Reference parity: radiation/radiation_cloud_generator.F90 — for each
g-point "subcolumn": pick a cloud top by inverse-CDF of the cumulative
cloud cover, walk down with the pair-cloud-cover Markov conditionals, and
assign optical-depth scalings from the water-content PDF with vertically
correlated random numbers (Exp-Ran correlates only within contiguous
cloudy blocks; Exp-Exp across the whole trigger..base range).

Differences from the reference: the lagged-Fibonacci stream is
replaced by counter-based RNG (jax.random, threefry) keyed on the
per-column iseed — preserving per-column determinism and shard-count
invariance (CHANGELOG:17-19) but not the exact stream, so McICA results
are statistically (not bitwise) equivalent. The per-g sequential loops
become one masked level-scan over all g simultaneously.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import Overlap
from .cloud_cover import (
    cum_cloud_cover_exp_exp,
    cum_cloud_cover_exp_ran,
    cum_cloud_cover_max_ran,
)
from .pdf_sampler import PdfSampler, sample_pdf, sample_pdf_fast


def cloud_generator(ng: int, iseed, overlap_scheme: Overlap,
                    frac_threshold: float, frac, overlap_param,
                    decorrelation_scaling: float, fractional_std,
                    pdf_sampler: PdfSampler,
                    is_beta_overlap: bool = False,
                    seed_offset: int = 0) -> Tuple:
    """Generate od_scaling (ncol, nlev, ng) + total_cloud_cover (ncol,).

    frac (ncol, nlev); overlap_param (ncol, nlev-1); iseed (ncol,) int.
    """
    ncol, nlev = frac.shape
    dtype = frac.dtype

    if overlap_scheme == Overlap.EXPONENTIAL_RANDOM:
        cum_cc, pcc = cum_cloud_cover_exp_ran(frac, overlap_param,
                                              is_beta_overlap)
    elif overlap_scheme == Overlap.MAXIMUM_RANDOM:
        cum_cc, pcc = cum_cloud_cover_max_ran(frac)
    else:
        cum_cc, pcc = cum_cloud_cover_exp_exp(frac, overlap_param,
                                              is_beta_overlap)

    total_cloud_cover = cum_cc[:, -1]
    overhang = cum_cc[:, 1:] - cum_cc[:, :-1]   # (ncol, nlev-1)

    has_cloud = total_cloud_cover >= frac_threshold
    total_cloud_cover = jnp.where(has_cloud, total_cloud_cover, 0.0)

    cloudy_lev = frac > 0.0
    levels = jnp.arange(nlev)
    ibegin = jnp.argmax(cloudy_lev, axis=1)                    # (ncol,)
    iend = nlev - 1 - jnp.argmax(cloudy_lev[:, ::-1], axis=1)  # (ncol,)

    # vertically-correlated-inhomogeneity overlap parameter
    alpha_inhom = jnp.where(
        overlap_param > 0.0,
        overlap_param ** (1.0 / decorrelation_scaling),
        overlap_param)

    # --- random fields, counter-based per column ------------------------
    def col_key(seed):
        return jax.random.fold_in(jax.random.PRNGKey(seed_offset), seed)

    keys = jax.vmap(col_key)(jnp.asarray(iseed, jnp.uint32))
    subkeys = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    rand_top = jax.vmap(
        lambda k: jax.random.uniform(k, (ng,), dtype))(subkeys[:, 0])
    rand_cloud = jax.vmap(
        lambda k: jax.random.uniform(k, (nlev, ng), dtype))(subkeys[:, 1])
    u1 = jax.vmap(
        lambda k: jax.random.uniform(k, (nlev, ng), dtype))(subkeys[:, 2])
    u2 = jax.vmap(
        lambda k: jax.random.uniform(k, (nlev, ng), dtype))(subkeys[:, 3])

    # --- cloud-top trigger per (col, g) ----------------------------------
    trigger = rand_top * total_cloud_cover[:, None]            # (ncol, ng)
    in_range = (levels[None, :] >= ibegin[:, None]) & (
        levels[None, :] <= iend[:, None])                      # (ncol,nlev)
    hit = (cum_cc[:, :, None] >= trigger[:, None, :]) \
        & in_range[:, :, None]
    itrigger = jnp.where(hit.any(axis=1),
                         jnp.argmax(hit, axis=1),
                         iend[:, None])                        # (ncol, ng)

    # --- masked Markov walk over levels ----------------------------------
    frac_prev = jnp.concatenate([jnp.zeros((ncol, 1), dtype),
                                 frac[:, :-1]], axis=1)
    cum_prev = jnp.concatenate([jnp.zeros((ncol, 1), dtype),
                                cum_cc[:, :-1]], axis=1)
    pcc_prev = jnp.concatenate([jnp.zeros((ncol, 1), dtype), pcc], axis=1)
    over_prev = jnp.concatenate([jnp.zeros((ncol, 1), dtype), overhang],
                                axis=1)

    def walk(cloudy, lev):
        u = rand_cloud[:, lev, :]                              # (ncol, ng)
        fp = frac_prev[:, lev][:, None]
        cond_stay = u * fp < (frac[:, lev][:, None] + fp
                              - pcc_prev[:, lev][:, None])
        clear_denom = cum_prev[:, lev][:, None] - fp
        cond_birth = u * clear_denom < (pcc_prev[:, lev][:, None]
                                        - over_prev[:, lev][:, None] - fp)
        at_trigger = itrigger == lev
        active = (lev > itrigger) & (lev <= iend[:, None])
        new_cloudy = jnp.where(
            at_trigger, True,
            jnp.where(active,
                      jnp.where(cloudy, cond_stay, cond_birth),
                      False))
        return new_cloudy, new_cloudy

    init = jnp.zeros((ncol, ng), bool)
    _, cloudy_levs = jax.lax.scan(walk, init, levels)
    is_cloudy = jnp.moveaxis(cloudy_levs, 0, 1)                # (ncol,nlev,ng)

    # --- vertically correlated inhomogeneity ----------------------------
    alpha_prev = jnp.concatenate([jnp.zeros((ncol, 1), dtype),
                                  alpha_inhom], axis=1)        # (ncol,nlev)
    exp_exp = overlap_scheme == Overlap.EXPONENTIAL_EXPONENTIAL

    is_cloudy_prev = jnp.concatenate(
        [jnp.zeros((ncol, 1, ng), bool), is_cloudy[:, :-1, :]], axis=1)

    def fill2(r_prev, lev):
        # Exp-Exp correlates across the whole trigger..base span;
        # Exp-Ran/Max-Ran only within contiguous cloudy runs.
        keep = u2[:, lev, :] < alpha_prev[:, lev][:, None]
        if exp_exp:
            in_span = (lev > itrigger) & (lev <= iend[:, None])
            keep = keep & in_span
        else:
            keep = keep & is_cloudy[:, lev, :] & is_cloudy_prev[:, lev, :]
        r = jnp.where(keep, r_prev, u1[:, lev, :])
        return r, r

    _, r_levs = jax.lax.scan(fill2, u1[:, 0, :], levels)
    rand_inhom = jnp.moveaxis(r_levs, 0, 1)                    # (ncol,nlev,ng)

    # --- PDF sample on cloudy cells --------------------------------------
    if pdf_sampler.cheb is not None:
        scaling = sample_pdf_fast(pdf_sampler, fractional_std, rand_inhom)
    else:
        fsd = fractional_std[:, :, None] * jnp.ones((1, 1, ng), dtype)
        scaling = sample_pdf(pdf_sampler, fsd, rand_inhom)
    od_scaling = jnp.where(is_cloudy & has_cloud[:, None, None],
                           scaling, 0.0)

    return od_scaling, total_cloud_cover
