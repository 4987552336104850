"""Unit tests for the table-interpolation op (ops/gather_interp.py)."""
import numpy as np
import jax.numpy as jnp

from ecrad_tpu.ops.gather_interp import (Section, eval_sections,
                                         separable_section)


def _rand_eta_terms(rng, n, r1=13, r2=9, g=12, n_fam=2):
    """A (R1, R2, G) table and per-family separable terms; grid and
    eta offsets stay inside the table."""
    table = rng.rand(r1, r2, g).astype(np.float32)
    grids, grid_terms, etas, eta_terms = [], [], [], []
    for _ in range(n_fam):
        grids.append(jnp.asarray(
            rng.randint(0, r1 - 1, n).astype(np.int32)))
        grid_terms.append([(o, jnp.asarray(rng.rand(n).astype(np.float32)))
                           for o in (0, 1)])
        etas.append(jnp.asarray(
            rng.randint(1, r2 - 2, n).astype(np.int32)))
        eta_terms.append([(o, jnp.asarray(rng.rand(n).astype(np.float32)))
                          for o in (-1, 0, 1, 2)])
    return table, grids, grid_terms, etas, eta_terms


def _rand_eta_section(rng, n):
    return separable_section(*_rand_eta_terms(rng, n))


def test_eta_section_matches_manual():
    rng = np.random.RandomState(0)
    n = 257
    table, grids, grid_terms, etas, eta_terms = _rand_eta_terms(rng, n)
    out = np.asarray(eval_sections([separable_section(
        table, grids, grid_terms, etas, eta_terms)]))
    r1, r2, g = table.shape
    want = np.zeros((g, n))
    for fam in range(2):
        grid = np.asarray(grids[fam])
        eta = np.asarray(etas[fam])
        for go, gw in grid_terms[fam]:
            for eo, ew in eta_terms[fam]:
                w = np.asarray(gw) * np.asarray(ew)
                want += w[None, :] * table[np.clip(grid + go, 0, r1 - 1),
                                           np.clip(eta + eo, 0, r2 - 1)].T
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_eta_flatten_roundtrip():
    """Every flattened row reads the (grid + go, eta + eo) entry of the
    2-D table, with weight gw * ew, family by family."""
    rng = np.random.RandomState(1)
    n = 64
    table, grids, grid_terms, etas, eta_terms = _rand_eta_terms(rng, n)
    sec = separable_section(table, grids, grid_terms, etas, eta_terms)
    r1, r2, g = table.shape
    assert np.asarray(sec.table).shape == (r1 * r2, g)
    rows, weights = iter(sec.rows), iter(sec.weights)
    for fam in range(2):
        for go, gw in grid_terms[fam]:
            for eo, ew in eta_terms[fam]:
                grid, eta = divmod(np.asarray(next(rows)), r2)
                np.testing.assert_array_equal(
                    grid, np.asarray(grids[fam]) + go)
                np.testing.assert_array_equal(
                    eta, np.asarray(etas[fam]) + eo)
                np.testing.assert_array_equal(
                    np.asarray(next(weights)),
                    np.asarray(gw) * np.asarray(ew))
    assert next(rows, None) is None and next(weights, None) is None
    np.testing.assert_array_equal(np.asarray(sec.table)[
        grid * r2 + eta], table[grid, eta])


def test_mixed_plain_and_eta():
    rng = np.random.RandomState(2)
    n = 100
    eta = _rand_eta_section(rng, n)
    tab = rng.rand(20, 12).astype(np.float32)
    plain = Section(tab,
                    [jnp.asarray(rng.randint(0, 20, n).astype(np.int32))],
                    [jnp.asarray(rng.rand(n).astype(np.float32))])
    got = np.asarray(eval_sections([plain, eta]))
    a = np.asarray(eval_sections([plain]))
    b = np.asarray(eval_sections([eta]))
    np.testing.assert_allclose(got, a + b, rtol=1e-5, atol=1e-5)
