"""Look-up-table sampling of the cloud water PDF for McICA.

Reference parity: radiation/radiation_pdf_sampler.F90 — a 2-D LUT
(fractional standard deviation x CDF -> optical-depth scaling) read from
data/mcica_{gamma,lognormal}.nc, sampled bilinearly (sample_from_pdf
:123-155 with cdf grid u_i=(i-1)/(ncdf-1)).

Fast path: instead of a per-element LUT gather over the (ncol, nlev, ng)
scaling field (>1e8 elements), each fsd row's quantile curve is refit at
setup as a Chebyshev series of ln(x) in z = ndtri(cdf). Sampling then
needs only a small per-(col,lev) coefficient-row gather plus an
elementwise Clenshaw evaluation, with max error ~1e-3 of the LUT value in
the physically occupied range (see tests/test_cloud_generator.py). Its
speed against the gather has not been measured on a GPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import RadiationConfig
from ..io.netcdf import NetcdfFile

CHEB_DEGREE = 16
CDF_MIN = 1.0e-4  # fitted/clamped cdf range; RNG output is (0,1) open
CDF_MAX = 1.0 - 1.0e-4


@dataclass
class PdfSampler:
    val: np.ndarray            # (ncdf, nfsd)
    fsd1: float
    inv_fsd_interval: float
    # Chebyshev fast path (fit at setup): ln(x) ~ cheb(t(z)) per fsd row
    cheb: Optional[np.ndarray] = None   # (nfsd, CHEB_DEGREE+1)
    z0: float = 0.0
    z1: float = 0.0

    @property
    def ncdf(self):
        return self.val.shape[0]

    @property
    def nfsd(self):
        return self.val.shape[1]


def _fit_chebyshev(val: np.ndarray) -> tuple:
    """Fit ln(x_row(cdf)) as Chebyshev in z = ndtri(cdf) per fsd row.

    The target is the *sampler's* effective function (linear interp of the
    row at grid u_i = i/(ncdf-1)), so the fit inherits the reference's
    grid convention exactly. Weighted toward values that matter
    (sqrt(max(x, 1e-4))): errors on negligible scalings are irrelevant."""
    from scipy.special import ndtri
    ncdf, nfsd = val.shape
    u_grid = np.linspace(0.0, 1.0, ncdf)
    # dense cdf samples, uniform in z for a well-conditioned fit
    z0, z1 = float(ndtri(CDF_MIN)), float(ndtri(CDF_MAX))
    z = np.linspace(z0, z1, 4001)
    from scipy.special import ndtr
    u = ndtr(z)
    t = (2.0 * z - (z0 + z1)) / (z1 - z0)
    cheb = np.zeros((nfsd, CHEB_DEGREE + 1))
    for j in range(nfsd):
        x = np.interp(u, u_grid, val[:, j])
        lnx = np.log(np.maximum(x, 1e-12))
        w = np.sqrt(np.maximum(x, 1e-4))
        cheb[j] = np.polynomial.chebyshev.chebfit(t, lnx, CHEB_DEGREE, w=w)
    return cheb.astype(np.float32), z0, z1


def setup_pdf_sampler(config: RadiationConfig) -> PdfSampler:
    with NetcdfFile(config.cloud_pdf_file) as f:
        fsd = f.read("fsd")
        val = f.read("x")
    # stored (nfsd, ncdf) or (ncdf, nfsd)? reference reads (ncdf, nfsd)
    if val.shape[0] == len(fsd):
        val = val.T
    cheb, z0, z1 = _fit_chebyshev(val)
    return PdfSampler(val=val, fsd1=float(fsd[0]),
                      inv_fsd_interval=float(1.0 / (fsd[1] - fsd[0])),
                      cheb=cheb, z0=z0, z1=z1)


def sample_pdf(sampler: PdfSampler, fsd, cdf):
    """Bilinear LUT sample (radiation_pdf_sampler.F90:123-155).

    fsd/cdf broadcastable arrays; returns od_scaling of same shape."""
    val = jnp.asarray(sampler.val, fsd.dtype)
    ncdf, nfsd = sampler.val.shape
    wcdf = cdf * (ncdf - 1) + 1.0
    icdf = jnp.clip(jnp.floor(wcdf).astype(jnp.int32), 1, ncdf - 1)
    wcdf = jnp.clip(wcdf - icdf, 0.0, 1.0)
    wfsd = (fsd - sampler.fsd1) * sampler.inv_fsd_interval + 1.0
    ifsd = jnp.clip(jnp.floor(wfsd).astype(jnp.int32), 1, nfsd - 1)
    wfsd = jnp.clip(wfsd - ifsd, 0.0, 1.0)
    # flat gather from (ncdf*nfsd,)
    flat = val.reshape(-1)
    i00 = (icdf - 1) * nfsd + (ifsd - 1)
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + nfsd]
    v11 = flat[i00 + nfsd + 1]
    return ((1.0 - wcdf) * (1.0 - wfsd) * v00
            + (1.0 - wcdf) * wfsd * v01
            + wcdf * (1.0 - wfsd) * v10
            + wcdf * wfsd * v11)


def sample_pdf_fast(sampler: PdfSampler, fsd, cdf):
    """Chebyshev-in-z evaluation of the PDF quantile (fast path).

    fsd: (ncol, nlev) — constant over g, so the coefficient-row gather is
    per (col, lev) only; cdf: (ncol, nlev, ng). Returns (ncol, nlev, ng).
    """
    from jax.scipy.special import ndtri
    cheb = jnp.asarray(sampler.cheb, cdf.dtype)   # (nfsd, D+1)
    nfsd = sampler.nfsd
    z = ndtri(jnp.clip(cdf, CDF_MIN, CDF_MAX))
    t = jnp.clip((2.0 * z - (sampler.z0 + sampler.z1))
                 / (sampler.z1 - sampler.z0), -1.0, 1.0)

    wfsd = (fsd - sampler.fsd1) * sampler.inv_fsd_interval
    ifsd = jnp.clip(jnp.floor(wfsd).astype(jnp.int32), 0, nfsd - 2)
    w = jnp.clip(wfsd - ifsd, 0.0, 1.0)[..., None]    # (ncol, nlev, 1)
    c0 = jnp.take(cheb, ifsd, axis=0)                 # (ncol, nlev, D+1)
    c1 = jnp.take(cheb, ifsd + 1, axis=0)

    def clenshaw(c):
        b1 = jnp.zeros_like(t)
        b2 = jnp.zeros_like(t)
        for k in range(CHEB_DEGREE, 0, -1):
            ck = c[..., k][..., None]
            b1, b2 = ck + 2.0 * t * b1 - b2, b1
        return c[..., 0][..., None] + t * b1 - b2

    x0 = jnp.exp(clenshaw(c0))
    x1 = jnp.exp(clenshaw(c1))
    return (1.0 - w) * x0 + w * x1
