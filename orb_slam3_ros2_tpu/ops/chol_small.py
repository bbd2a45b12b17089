"""Unrolled Cholesky solves for tiny fixed-size SPD systems.

`jnp.linalg.solve` lowers to a library custom call (an LU with pivoting):
one more kernel launch with its own fixed cost, inside the tracking LM loop
that solves one 6x6 system per iteration. Unrolling the factorization into
~150 scalar ops lets XLA fuse the entire solve into the surrounding kernel:
no custom call, no extra launch.

Python loops here unroll at trace time (n is a static int)."""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3_spd(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of batched SPD 3x3 blocks.

    `jnp.linalg.inv` on (L, 3, 3) lowers to a batched LU *custom call*,
    a separate launch that XLA cannot fuse with the per-landmark work
    around it. The adjugate form is ~40 fused
    elementwise ops on (L,) lanes: exact for SPD blocks (determinant
    bounded away from 0 by the caller's damping) and keeps the whole
    Schur elimination inside one XLA fusion.

    A: (..., 3, 3) symmetric positive definite. Returns (..., 3, 3).
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    # cofactors of the symmetric matrix [[a,b,c],[b,d,e],[c,e,f]]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    row0 = jnp.stack([A00, A01, A02], axis=-1)
    row1 = jnp.stack([A01, A11, A12], axis=-1)
    row2 = jnp.stack([A02, A12, A22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def cholesky_solve_small(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for SPD A of small static size n (n <= ~12 sensible).

    A: (n, n) symmetric positive definite (caller adds damping).
    b: (n,). Returns x: (n,)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)
