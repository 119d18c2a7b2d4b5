"""2D rigid-body math on tensors with a trailing dim of 2.

Rotations are (sin, cos) pairs (reference: include/solver2d/types.h:36-40).
Every function broadcasts over leading dims and keeps the JAX package's
operation order, so results agree to the last bit on the same device.
"""

from __future__ import annotations

import math

import torch


def cross(a, b):
    """2D cross product -> scalar (reference: math.h:53-56)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """s x v (reference: math.h:67-70); s has v's leading shape."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def right_perp(v):
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def sqrt(x):
    """The correctly rounded square root of a float32 tensor, as JAX and
    CUDA compute it. PyTorch's vectorized CPU kernel is not correctly
    rounded (about 0.7% of float32 inputs come out 1 ulp off with AVX-512),
    so on the CPU it is taken in float64, whose rounding to float32 is exact
    for a square root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def make_rot(angle, device=None):
    """The rotation (sin, cos) of float32 angles. Taken in float64 and
    rounded to float32, so that the card and the CPU give the same bits;
    XLA's float32 sin and cos, which the JAX package calls, differ from
    these correctly rounded values by 1 ulp on a small share of angles."""
    a = torch.as_tensor(angle, dtype=torch.float32, device=device).double()
    return torch.stack([torch.sin(a), torch.cos(a)], dim=-1).float()


def normalize_rot(q):
    mag = sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
    inv = torch.where(mag > 0.0, 1.0 / torch.clamp(mag, min=1e-30), 0.0)
    return q * inv[..., None]


def integrate_rot(q, omega_h):
    """First-order update + renormalize (reference: math.h:209-236)."""
    s = q[..., 0] + omega_h * q[..., 1]
    c = q[..., 1] - omega_h * q[..., 0]
    return normalize_rot(torch.stack([s, c], dim=-1))


def rotate(q, v):
    """(reference: math.h:330-341)"""
    x = q[..., 1] * v[..., 0] - q[..., 0] * v[..., 1]
    y = q[..., 0] * v[..., 0] + q[..., 1] * v[..., 1]
    return torch.stack([x, y], dim=-1)


def atan2(y, x):
    """The JAX package's branch-free atan2 (`ops/math2d.py:atan2`): octant
    reduction to |z| <= tan(pi/8), then the Cephes atanf polynomial, from
    mul/add/select only, so the fused solve kernel (csrc/fused_solve.cu)
    computes it with the same operations. Not `torch.atan2`: the joints'
    angles must round as the reference's do. atan2(-0.0, x<0) is +pi, as
    there."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = lo / torch.where(hi > 0.0, hi, 1.0)
    big = a > 0.4142135623730950
    z = torch.where(big, (a - 1.0) / (a + 1.0), a)
    z2 = z * z
    p = (((8.05374449538e-2 * z2 - 1.38776856032e-1) * z2 + 1.99777106478e-1)
         * z2 - 3.33329491874e-1) * z2 * z + z
    t = torch.where(big, 0.25 * math.pi + p, p)
    t = torch.where(ay > ax, 0.5 * math.pi - t, t)
    t = torch.where(x < 0.0, math.pi - t, t)
    return torch.where(y < 0.0, -t, t)


def relative_angle(b, a):
    """Angle of rot b relative to rot a (reference: math.h:320-327)."""
    s = b[..., 0] * a[..., 1] - b[..., 1] * a[..., 0]
    c = b[..., 1] * a[..., 1] + b[..., 0] * a[..., 0]
    return atan2(s, c)
