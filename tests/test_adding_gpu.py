"""The adding-sweep kernels (ops/adding_gpu.py) against their lax.scan
reference (the `_*_sequential` forms in solvers/adding.py).

On the CPU the kernels run in Pallas interpret mode; the `gpu` test
compiles them for the card. Shapes are chosen so that the flattened
(g, column) lanes do not fill the last block.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecrad_tpu.ops import adding_gpu as K
from ecrad_tpu.solvers import adding as A

# (nlev, ng, ncol): 804 and 185 lanes, neither a multiple of BLOCK
SHAPES = [(17, 12, 67), (5, 37, 5)]


def _rand(rng, *shape, lo=0.0, hi=1.0):
    return jnp.asarray((lo + (hi - lo) * rng.rand(*shape))
                       .astype(np.float32))


def sw_args(nlev, ng, ncol, seed=0):
    """Physical ranges: R + T < 1, the direct beam attenuates."""
    rng = np.random.RandomState(seed)
    r = functools.partial(_rand, rng)
    return (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
            r(nlev, ng, ncol, hi=0.3), r(nlev, ng, ncol, hi=0.4),
            r(nlev, ng, ncol, lo=0.2, hi=0.9), r(ng, ncol, hi=1300.0),
            r(ng, ncol, hi=0.8), r(ng, ncol, hi=0.8),
            r(ncol, lo=0.05))


def lw_args(nlev, ng, ncol, seed=0):
    rng = np.random.RandomState(seed)
    r = functools.partial(_rand, rng)
    return (r(nlev, ng, ncol, hi=0.4), r(nlev, ng, ncol, lo=0.3, hi=0.6),
            r(nlev, ng, ncol, hi=20.0), r(nlev, ng, ncol, hi=20.0),
            r(ng, ncol, hi=400.0), r(ng, ncol, hi=0.2))


def _kernel_and_scan(name, args, interpret):
    """(kernel outputs, lax.scan outputs) for one sweep family."""
    if name == "sw":
        mu0 = args[8]
        kern = K.adding_sw(*args[:8], mu0.reshape(1, -1),
                           interpret=interpret)
        ref = A._adding_sw_sequential(*args[:8], mu0[:, None],
                                      gfirst=True)
    elif name == "lw":
        kern = K.adding_lw(*args, interpret=interpret)
        ref = A._adding_lw_sequential(*args, gfirst=True)
    else:
        kern = K.lw_no_scattering(*args[1:], interpret=interpret)
        ref = A._lw_no_scattering_sequential(*args[1:], gfirst=True)
    return kern, ref


def _args(name, shape):
    return sw_args(*shape) if name == "sw" else lw_args(*shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["sw", "lw", "lw_noscat"])
def test_kernel_matches_scan_interpret(name, shape):
    kern, ref = _kernel_and_scan(name, _args(name, shape), interpret=True)
    assert len(kern) == len(ref)
    nlev, ng, ncol = shape
    for k, r in zip(kern, ref):
        assert k.shape == (nlev + 1, ng, ncol) == r.shape
        np.testing.assert_allclose(np.asarray(k), np.asarray(r),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.abs(np.asarray(r)).max()))


def test_use_kernel_only_on_gpu_in_f32():
    """The solvers choose the kernels only for f32 on a GPU backend;
    on this CPU run they take the lax.scan forms."""
    x = jnp.zeros((4, 3, 2), jnp.float32)
    assert A._use_kernel(x) == (jax.default_backend() == "gpu")
    assert not A._use_kernel(x.astype(jnp.float16))
    assert K.fits(137, 140, 8192)
    assert not K.fits(137, 140, 2 ** 17)


def test_public_adding_matches_reference_layout():
    """adding_sw with gfirst=True (kernel where it applies) agrees with
    the un-transposed (..., nlev, ng) call."""
    args = sw_args(6, 4, 9)
    up, dn, dr = A.adding_sw(*args, gfirst=True)
    ct = lambda x: jnp.moveaxis(x, (0, 1), (-2, -1))
    up2, dn2, dr2 = A.adding_sw(*[ct(x) for x in args[:5]],
                                *[x.T for x in args[5:8]], args[8])
    for a, b in ((up, up2), (dn, dn2), (dr, dr2)):
        np.testing.assert_allclose(np.asarray(ct(a)), np.asarray(b),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sw", "lw", "lw_noscat"])
def test_kernel_matches_scan_on_gpu(gpu, name):
    """Compiled for the card: the kernel against the scan, 137 levels."""
    args = jax.device_put(_args(name, (137, 16, 1000)), gpu)
    kern, ref = jax.jit(lambda *a: _kernel_and_scan(name, a, False))(*args)
    for k, r in zip(kern, ref):
        r = np.asarray(r)
        assert np.abs(np.asarray(k) - r).max() <= 1e-5 * np.abs(r).max()
