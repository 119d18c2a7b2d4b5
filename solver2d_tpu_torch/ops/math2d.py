"""2D rigid-body math on tensors with a trailing dim of 2.

Rotations are (sin, cos) pairs (reference: include/solver2d/types.h:36-40).
Every function broadcasts over leading dims and keeps the JAX package's
operation order, so results agree to the last bit on the same device.
"""

from __future__ import annotations

import torch


def cross(a, b):
    """2D cross product -> scalar (reference: math.h:53-56)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """s x v (reference: math.h:67-70); s has v's leading shape."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def right_perp(v):
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def normalize_rot(q):
    mag = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
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
