"""Cumulative cloud cover under different overlap assumptions.

Reference parity: radiation/radiation_cloud_cover.F90 — beta->alpha
conversion (:49), Max-Ran (:121), Exp-Ran (:181) and Exp-Exp (:283)
cumulative cloud cover. All functions are vectorized over a leading
column batch: frac (ncol, nlev), overlap_param (ncol, nlev-1); they
return (cum_cloud_cover, pair_cloud_cover) of shapes (ncol, nlev) and
(ncol, nlev-1).

Exp-Ran / Max-Ran are level scans. Exp-Exp requires identifying cloud
"objects" (rise-fall segments of the profile) and merging them in order
of decreasing inter-object overlap — here expressed with a per-column
bounded fori_loop over object slots, vmapped over columns.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


MAX_CLOUD_FRAC = 1.0 - 1.2e-6  # float32 counterpart of 1-10*eps
MIN_FRAC = 1.0e-6


def beta2alpha(beta, frac1, frac2):
    """Shonk et al. beta -> Hogan-Illingworth alpha (:49)."""
    frac_diff = jnp.abs(frac1 - frac2)
    alpha = beta + (1.0 - beta) * frac_diff / (
        frac_diff + 1.0 / jnp.maximum(beta, 1e-12) - 1.0)
    return jnp.where(beta < 1.0, alpha, 1.0)


def _pair_cloud_cover(frac, overlap_param, is_beta):
    f1 = frac[:, :-1]
    f2 = frac[:, 1:]
    alpha = beta2alpha(overlap_param, f1, f2) if is_beta else overlap_param
    pcc = (alpha * jnp.maximum(f1, f2)
           + (1.0 - alpha) * (f1 + f2 - f1 * f2))
    return pcc, alpha


def cum_cloud_cover_max_ran(frac):
    """Maximum-random overlap (:121). pair cover = max(f1, f2)."""
    f1 = frac[:, :-1]
    f2 = frac[:, 1:]
    pcc = jnp.maximum(f1, f2)
    return _cum_from_pair(frac, pcc), pcc


def cum_cloud_cover_exp_ran(frac, overlap_param, is_beta=False):
    """Exponential-random overlap (:181)."""
    pcc, _ = _pair_cloud_cover(frac, overlap_param, is_beta)
    return _cum_from_pair(frac, pcc), pcc


def _cum_from_pair(frac, pcc):
    """cum(1) = frac(1); cum(l+1) = 1 - (1-cum(l))(1-pcc(l))/(1-frac(l)),
    with total cover saturating at overcast layers."""
    ratio = jnp.where(frac[:, :-1] >= MAX_CLOUD_FRAC,
                      0.0,
                      (1.0 - pcc) / jnp.maximum(1.0 - frac[:, :-1], 1e-12))
    # cum_product(l+1) = cum_product(l) * ratio(l): a cumulative product
    start = (1.0 - frac[:, :1])
    cumprod = start * jnp.cumprod(ratio, axis=1)
    cum = 1.0 - jnp.concatenate([start, cumprod], axis=1)
    return cum


# ---------------------------------------------------------------------------
# Exp-Exp (:283): object detection + ordered merging
# ---------------------------------------------------------------------------

def _exp_exp_column(frac, overlap_param, pcc, alpha):
    """Single column. frac (nlev,), overlap_param/alpha/pcc (nlev-1,).

    Returns (cum_cloud_cover (nlev,), pair_cloud_cover (nlev-1,))."""
    nlev = frac.shape[0]
    nobj_max = (nlev + 1) // 2 + 1

    cloudy = frac > MIN_FRAC
    prev_cloudy = jnp.concatenate([jnp.array([False]), cloudy[:-1]])
    prev_frac = jnp.concatenate([jnp.zeros(1, frac.dtype), frac[:-1]])

    # scan to label objects: new object at cloud onset, or when frac
    # rises again after a descent within a run
    def scan_obj(carry, x):
        in_obj, desc, obj_id = carry
        is_cloudy, was_cloudy, f, fp = x
        new_obj = is_cloudy & ((~was_cloudy) | (~in_obj)
                               | (desc & (f > fp)))
        obj_id = jnp.where(new_obj, obj_id + 1, obj_id)
        desc = jnp.where(new_obj, False,
                         jnp.where(is_cloudy & in_obj & (f < fp), True,
                                   desc))
        in_obj = is_cloudy
        return (in_obj, desc, obj_id), (obj_id, desc)

    (_, _, _), (obj_id_lev, desc_lev) = jax.lax.scan(
        scan_obj, (False, False, jnp.int32(-1)),
        (cloudy, prev_cloudy, frac, prev_frac))
    obj_of_lev = jnp.where(cloudy, obj_id_lev, nobj_max)  # segment ids
    nobj = jnp.max(jnp.where(cloudy, obj_id_lev, -1)) + 1

    levels = jnp.arange(nlev)
    big = nlev + 10
    i_top = jax.ops.segment_min(levels, obj_of_lev, nobj_max + 1)[:nobj_max]
    i_base = jax.ops.segment_max(
        jnp.where(cloudy, levels, -1), obj_of_lev,
        nobj_max + 1)[:nobj_max]
    # i_max: last ascending level of the object
    asc_level = jnp.where(cloudy & (~desc_lev), levels, -1)
    i_max = jax.ops.segment_max(asc_level, obj_of_lev,
                                nobj_max + 1)[:nobj_max]
    valid_obj = jnp.arange(nobj_max) < nobj
    i_top = jnp.where(valid_obj, i_top, big)
    i_base = jnp.where(valid_obj, i_base, big)
    i_max = jnp.where(valid_obj, i_max, big)

    # per-object alpha to the NEXT object: product of alpha over
    # [i_max(j), i_max(j+1)-1] (1-based fortran indices of overlap_param
    # = interface below level). 0-based: alpha[l] couples lev l, l+1;
    # product over l in [i_max(j), i_max(j+1)-1].
    safe = jnp.maximum(alpha, 1e-35)
    logcum = jnp.concatenate([jnp.zeros(1, frac.dtype),
                              jnp.cumsum(jnp.log(safe))])
    zerocum = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum((alpha <= 0).astype(jnp.int32))])

    def range_product(a, b):
        # product of alpha[a:b] (0-based, exclusive b); empty -> 1
        lp = logcum[jnp.clip(b, 0, nlev - 1)] - logcum[jnp.clip(a, 0,
                                                                nlev - 1)]
        nz = zerocum[jnp.clip(b, 0, nlev - 1)] - zerocum[jnp.clip(a, 0,
                                                                  nlev - 1)]
        return jnp.where(b <= a, 1.0,
                         jnp.where(nz > 0, 0.0, jnp.exp(lp)))

    i_max_next = jnp.concatenate([i_max[1:], jnp.array([big])])
    alpha_obj = range_product(i_max, i_max_next)
    alpha_obj = jnp.where(valid_obj, alpha_obj, -1.0)

    # within-object cumulative cover: same recurrence as exp-ran but
    # restarting at each object top. Express as a masked scan:
    def scan_cum(carry, x):
        cum_prev = carry
        lev = x
        at_top = jnp.any((i_top == lev) & valid_obj)
        in_object = cloudy[lev]
        f_prev = prev_frac[lev]
        pcc_prev = jnp.where(lev > 0, pcc[jnp.maximum(lev - 1, 0)], 0.0)
        cum_rec = jnp.where(
            f_prev >= MAX_CLOUD_FRAC, 1.0,
            1.0 - (1.0 - cum_prev) * (1.0 - pcc_prev)
            / jnp.maximum(1.0 - f_prev, 1e-12))
        cum_here = jnp.where(at_top, frac[lev],
                             jnp.where(in_object, cum_rec, 0.0))
        return cum_here, cum_here

    _, cum_cc = jax.lax.scan(scan_cum, 0.0, levels)

    cc_obj = cum_cc[jnp.clip(i_base, 0, nlev - 1)]
    cc_obj = jnp.where(valid_obj, cc_obj, 0.0)

    # ---- ordered merging ----------------------------------------------
    def merge_body(_, state):
        cum_cc, cc_obj, alpha_obj, i_base_s, i_next, active, n_active = \
            state

        def do_merge(state):
            cum_cc, cc_obj, alpha_obj, i_base_s, i_next, active, \
                n_active = state
            # The reference traverses the linked list while the 1-based
            # slot index < remaining object count
            # (radiation_cloud_cover.F90 exp-exp merge loop), so only
            # active slots with index+1 < n_active are candidates.
            slot = jnp.arange(nobj_max)  # 0-based; 1-based index = slot+1
            candidate = active & valid_obj & (slot < n_active - 1)
            score = jnp.where(candidate, alpha_obj, -jnp.inf)
            j = jnp.argmax(score)
            k = i_next[j]
            base_j = i_base_s[j]
            top_k = i_top[k]
            base_k = i_base_s[k]
            cc_j = cc_obj[j]
            cc_k = cc_obj[k]
            a = alpha_obj[j]
            cc_base_j = cum_cc[jnp.clip(base_j, 0, nlev - 1)]
            # gap fill between the objects
            gap = (levels > base_j) & (levels < top_k)
            cum_new = jnp.where(gap, cc_base_j, cum_cc)
            cc_pair = (a * jnp.maximum(cc_j, cc_k)
                       + (1.0 - a) * (cc_j + cc_k - cc_j * cc_k))
            scaling = jnp.clip((cc_pair - cc_j)
                               / jnp.maximum(MIN_FRAC, cc_k), 0.0, 1.0)
            inobj2 = (levels >= top_k) & (levels <= base_k)
            cum_new = jnp.where(inobj2, cc_base_j + cum_cc * scaling,
                                cum_new)
            cc_obj = cc_obj.at[j].set(cc_pair)
            i_base_s = i_base_s.at[j].set(base_k)
            i_next_new = i_next.at[j].set(i_next[k])
            alpha_obj = alpha_obj.at[j].set(alpha_obj[k])
            active = active.at[k].set(False)
            return (cum_new, cc_obj, alpha_obj, i_base_s, i_next_new,
                    active, n_active - 1)

        return jax.lax.cond(n_active > 1, do_merge, lambda s: s, state)

    i_next0 = jnp.arange(1, nobj_max + 1)
    active0 = valid_obj
    state = (cum_cc, cc_obj, alpha_obj, i_base, i_next0, active0, nobj)
    # early-exit while loop: real profiles have far fewer cloud objects
    # than the worst-case bound, and under vmap the condition becomes
    # "any column still merging"
    state = jax.lax.while_loop(
        lambda s: s[-1] > 1, lambda s: merge_body(0, s), state)
    cum_cc, cc_obj, alpha_obj, i_base_s, i_next, active, _ = state

    # fill below the final base
    final_base = i_base_s[0]
    has_cloud = nobj > 0
    cc_final = cum_cc[jnp.clip(final_base, 0, nlev - 1)]
    cum_cc = jnp.where(has_cloud & (levels > final_base), cc_final, cum_cc)
    cum_cc = jnp.minimum(cum_cc, 1.0)
    cum_cc = jnp.where(has_cloud, cum_cc, 0.0)

    pcc_out = jnp.maximum(pcc, frac[:-1] + cum_cc[1:] - cum_cc[:-1])
    pcc_out = jnp.where(has_cloud, pcc_out, 0.0)
    return cum_cc, pcc_out


def cum_cloud_cover_exp_exp(frac, overlap_param, is_beta=False):
    """Exponential-exponential overlap (:283)."""
    pcc, alpha = _pair_cloud_cover(frac, overlap_param, is_beta)
    cum, pcc_out = jax.vmap(_exp_exp_column)(frac, overlap_param, pcc,
                                             alpha)
    return cum, pcc_out
