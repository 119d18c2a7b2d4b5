"""Port 2D math (solver2d_tpu_torch.ops.math2d) vs the JAX package's
`ops/math2d.py`: the branch-free atan2 polynomial and the rotation helpers
the joints read, bit for bit on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solver2d_tpu.ops import math2d as jm
from solver2d_tpu_torch.ops import math2d as pm

torch.set_num_threads(1)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _inputs(seed, n=20000):
    rng = np.random.RandomState(seed)
    y = rng.normal(size=n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    # axes, the diagonal, zeros of either sign and the octant boundaries
    edge = np.array([0.0, -0.0, 1.0, -1.0, 0.4142135, 0.41421357, 2.4142137, 1e-30, -1e-30], np.float32)
    y = np.concatenate([y, np.repeat(edge, len(edge))])
    x = np.concatenate([x, np.tile(edge, len(edge))])
    return y, x


@pytest.mark.parametrize("seed", [0, 1])
def test_atan2_is_the_package_polynomial(seed):
    y, x = _inputs(seed)
    ref = jm.atan2(jnp.asarray(y), jnp.asarray(x))
    got = pm.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    ok = np.isfinite(got) & ((np.abs(x) + np.abs(y)) > 0)
    assert np.abs(got - np.arctan2(y, x))[ok & (y != 0)].max() < 1e-6


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(2)
    a, b = (rng.uniform(-4, 4, 5000).astype(np.float32) for _ in range(2))
    qa = np.stack([np.sin(a), np.cos(a)], -1).astype(np.float32)
    qb = np.stack([np.sin(b), np.cos(b)], -1).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(qa), jnp.asarray(qb), torch.from_numpy(qa), torch.from_numpy(qb)
    for name, ref, got in (
        ("rot_angle", jm.rot_angle(ja), pm.rot_angle(ta)),
        ("mul_rot", jm.mul_rot(jb, ja), pm.mul_rot(tb, ta)),
        ("inv_mul_rot", jm.inv_mul_rot(jb, ja), pm.inv_mul_rot(tb, ta)),
        ("relative_angle", jm.relative_angle(jb, ja), pm.relative_angle(tb, ta)),
    ):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref), err_msg=name)
