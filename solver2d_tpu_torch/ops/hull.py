"""2D convex hull of a small point cloud (host, numpy).

An own copy of the JAX package's `ops/hull.py`, the behavioural equivalent
of the reference's quickhull (reference: src/hull.c:88-326): the same
welding tolerance (16 * slop^2) and collinear rejection band (2 * slop),
CCW output, at most 8 vertices, built by monotone chain.
"""

from __future__ import annotations

import numpy as np

from ..config import LINEAR_SLOP, MAX_POLYGON_VERTICES


def compute_hull(points) -> np.ndarray | None:
    """CCW hull vertices [n, 2] (3 <= n <= 8), or None if degenerate."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 3 or len(pts) > MAX_POLYGON_VERTICES:
        return None

    # weld points closer than 4 slops (reference: src/hull.c:104-131)
    tol_sqr = 16.0 * LINEAR_SLOP * LINEAR_SLOP
    kept: list[np.ndarray] = []
    for p in pts:
        if all(((p - q) @ (p - q)) >= tol_sqr for q in kept):
            kept.append(p)
    if len(kept) < 3:
        return None
    ps = np.array(kept)
    ps = ps[np.lexsort((ps[:, 1], ps[:, 0]))]

    def half(points_iter):
        chain: list[np.ndarray] = []
        for p in points_iter:
            while len(chain) >= 2:
                a, b = chain[-2], chain[-1]
                # keep strictly convex corners outside the collinear band
                # (reference: src/hull.c:186-196)
                ab = b - a
                ap = p - a
                cr = ab[0] * ap[1] - ab[1] * ap[0]
                e = ap / max(np.linalg.norm(ap), 1e-12)
                d = ab[0] * e[1] - ab[1] * e[0]
                if cr > 0.0 and d > 2.0 * LINEAR_SLOP:
                    break
                chain.pop()
            chain.append(p)
        return chain

    lower = half(ps)
    upper = half(ps[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 3 or len(hull) > MAX_POLYGON_VERTICES:
        return None if len(hull) < 3 else hull[:MAX_POLYGON_VERTICES]
    return hull
