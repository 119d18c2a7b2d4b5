"""Helpers of the port's parity tests (tests/test_torch_*.py): carry JAX
values to the port as numpy arrays and compare trees of outputs.

JAX runs op by op (`jax.disable_jit()`) in these tests: tracing and
compiling the unrolled step programs costs minutes on the CPU, while the
eager ops of a base-3 scene take seconds.
"""

import numpy as np
import jax

# float32 round-off: both sides compute the same operations in the same
# order, so values agree to a few ulps
F32 = dict(rtol=1e-5, atol=1e-5)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def _get(obj, k):
    return obj[k] if isinstance(obj, dict) else getattr(obj, k)


def assert_tree_close(port: dict, ref, tol=F32, path=""):
    """Every leaf of the port's numpy tree (`to_numpy`) against the same
    field of the JAX tree: integers and bools exactly, floats within tol."""
    for k, v in port.items():
        r = _get(ref, k)
        if isinstance(v, dict):
            assert_tree_close(v, r, tol, f"{path}{k}.")
            continue
        r = np.asarray(r)
        name = f"{path}{k}"
        assert v.shape == r.shape, (name, v.shape, r.shape)
        assert v.dtype == r.dtype, (name, v.dtype, r.dtype)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, r, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(v, r, err_msg=name)


def to_jax(template, port: dict):
    """The JAX dataclass `template` with every field the port keeps replaced
    by the port's numpy values (nested)."""
    import dataclasses

    import jax.numpy as jnp

    kw = {}
    for k, v in port.items():
        t = getattr(template, k)
        kw[k] = to_jax(t, v) if isinstance(v, dict) else jnp.asarray(v)
    return dataclasses.replace(template, **kw)
