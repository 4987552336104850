"""Weighted table-row interpolation: the RRTMG k-table lookups.

The RRTMG taumol stage is dominated by expressions of the form

    out[g, cell] = sum_k  w_k[cell] * TABLE_s(k)[row_k[cell], g]

(k-table corner interpolation, water-vapour continuum, minor gases,
Planck fractions; e.g. ifsrrtm/rrtm_taumol1.F90:199-283). A band's
lookups are a list of sections, each a table plus per-cell rows and
weights; `eval_sections` evaluates them as row gathers (`jnp.take`)
and a weighted sum. On the GPU a gather is a native memory operation
and the tables (a few MB in all) stay in L2.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np


class Section(NamedTuple):
    """One lookup table plus its per-cell rows/weights.

    table: (R_s, G) numpy/jnp — rows indexed per cell.
    rows:  list of (N,) int32 arrays (0-based row index per cell).
    weights: list of (N,) float arrays, same length as rows.
    """
    table: jnp.ndarray
    rows: Sequence[jnp.ndarray]
    weights: Sequence[jnp.ndarray]


def separable_section(table, grids, grid_terms, etas,
                      eta_terms) -> Section:
    """A separable 2-D interpolation on a (R1, R2, G) table, as a
    plain Section over the flattened (R1*R2, G) table.

    RRTMG's binary-species (eta) lookups touch rows r = grid*R2 + eta
    with weights that factor exactly as an outer product
    w(grid_off, eta_off) = gw[grid_off] * ew[eta_off] per family
    (jp/jt corner x eta 3-point scheme): n_go * n_eo lookups per family.

    Per family f: grids[f] (N,) int32 base grid index; grid_terms[f] a
    list of (static_offset, weight (N,)); etas[f] (N,) int32 base eta
    index; eta_terms[f] a list of (static_offset, weight (N,)).
    """
    tab = np.asarray(table)
    r1, r2, g = tab.shape
    rows, weights = [], []
    for grid, gterms, eta, eterms in zip(grids, grid_terms, etas,
                                         eta_terms):
        for go, gw in gterms:
            for eo, ew in eterms:
                rows.append(grid * r2 + go * r2 + eta + eo)
                weights.append(gw * ew)
    return Section(tab.reshape(r1 * r2, g), rows, weights)


def eval_sections(sections: List[Section],
                  dtype=jnp.float32) -> jnp.ndarray:
    """Sum of the sections' weighted row lookups, (G, N).

    All sections must share the table's trailing (g) dimension. Rows
    are clipped to the table."""
    out = None
    for sec in sections:
        tab = jnp.asarray(sec.table, dtype)           # (R, G)
        for r, w in zip(sec.rows, sec.weights):
            term = jnp.take(tab, jnp.clip(r, 0, tab.shape[0] - 1),
                            axis=0).T * w[None, :]
            out = term if out is None else out + term
    return out
