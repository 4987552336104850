"""The pytree dataclasses (ecrad_tpu/pytree.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from ecrad_tpu.pytree import pytree_dataclass, static_field
from ecrad_tpu.types import GasConcs


@pytree_dataclass
class _Pair:
    a: jnp.ndarray
    b: object = None
    tag: tuple = static_field(("x",))


def test_replace_and_static_fields_round_trip():
    p = _Pair(a=jnp.ones(3), b=jnp.zeros(2))
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2                       # tag is not a leaf
    q = jax.tree.unflatten(treedef, leaves)
    assert q.tag == ("x",) and np.array_equal(q.a, p.a)
    r = p.replace(tag=("y",), b=None)
    assert r.tag == ("y",) and r.b is None and p.tag == ("x",)
    assert len(jax.tree.leaves(r)) == 1
    # a static field is part of the treedef: a new value retraces
    traces = []

    @jax.jit
    def f(x):
        traces.append(x.tag)
        return x.a * 2.0

    f(p)
    f(p.replace(a=jnp.full(3, 2.0, jnp.float32)))
    f(r)
    assert traces == [("x",), ("y",)]


def test_library_types_keep_static_metadata():
    g = GasConcs.create(2, 3)
    g2 = g.replace(is_present=(True,) + g.is_present[1:])
    assert g2.is_present[0] and not g.is_present[0]
    assert len(jax.tree.leaves(g2)) == 1
    out = jax.jit(lambda x: x)(g2)
    assert out.is_present == g2.is_present
