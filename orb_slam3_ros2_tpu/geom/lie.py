"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

Fixed-shape replacement for the reference's Sophus dependency
(`/root/reference/CMakeLists.txt:43` finds Sophus; wrapper stores poses as
`Sophus::SE3f`, `/root/reference/src/imu_mono_realsense.cpp:544`). Instead of
a C++ class hierarchy, every group element is a plain array (or a pair of
arrays) and every op is a pure function that broadcasts over leading batch
dimensions, so the whole engine state stays a pytree and `vmap`/`scan`/`pjit`
compose freely.

Conventions
-----------
* Rotations are 3x3 matrices with shape (..., 3, 3).
* SE(3) is the pair (R, t): R (..., 3, 3), t (..., 3). `X = (R, t)` acts on
  points as `x' = R @ x + t`.
* Sim(3) is the triple (R, t, s) with scalar scale s (...,): acts as
  `x' = s * R @ x + t`.
* Tangent vectors: so3 (..., 3); se3 (..., 6) ordered [rho, phi]
  (translation first, rotation second); sim3 (..., 7) ordered [rho, phi, sigma].
* All small-angle branches use Taylor guards (`jnp.where` on theta^2) so the
  functions are jit-safe and NaN-free at the identity, including gradients.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(Phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1)


def _sinc_cos_coeffs(theta_sq: jnp.ndarray):
    """Return (A, B, C) = (sin θ/θ, (1-cos θ)/θ², (θ-sin θ)/θ³), Taylor-guarded.

    Every denominator uses the guarded `safe_ts` so the *untaken* branch of
    each `where` is finite — otherwise reverse-mode AD propagates NaN through
    `where` (0·inf) and gradients at the identity blow up.
    """
    small = theta_sq < _EPS
    safe_ts = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_ts)
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe_ts)
    c = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / safe_ts)
    return a, b, c


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) (Rodrigues), (..., 3) -> (..., 3, 3)."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _sinc_cos_coeffs(theta_sq)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return eye + a[..., None, None] * Phi + b[..., None, None] * Phi2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3).

    Handles the θ≈0 and θ≈π branches; the π branch uses the diagonal of
    (R + I)/2 = axis axisᵀ to recover the axis stably.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # arccos has infinite derivative at ±1; clip its *input* so autodiff
    # through the generic branch stays finite, and use a cos-based series
    # (no θ) in the near-zero branch — the usual double-where guard.
    cos_safe = jnp.clip(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_safe)
    near_pi = cos_theta < -1.0 + 1e-6
    near_zero = cos_theta > 1.0 - 1e-6

    # Generic branch: vee((R - R^T)/2) * theta / sin(theta).
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5
    sin_theta = jnp.sin(theta)
    # θ/sinθ = 1 + θ²/6 + …, with θ² ≈ 2(1−cosθ) — AD-safe at identity
    scale = jnp.where(
        near_zero,
        1.0 + (1.0 - cos_theta) / 3.0,
        theta / jnp.where(jnp.abs(sin_theta) < 1e-12, 1.0, sin_theta),
    )
    log_generic = w * scale[..., None]

    # θ≈π branch: axis from largest diagonal of S = (R + I); sign fixed from w.
    S = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(S, k[..., None, None].repeat(3, axis=-2), axis=-1)[
        ..., 0
    ]
    axis = col / jnp.linalg.norm(col, axis=-1, keepdims=True).clip(1e-12)
    # Disambiguate sign using the skew part (zero exactly at π; any sign valid).
    sign = jnp.where(jnp.sum(axis * w, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    log_pi = axis * sign * theta[..., None]

    return jnp.where(near_pi[..., None], log_pi, log_generic)


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J_l of SO(3): (..., 3) -> (..., 3, 3)."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    _, b, c = _sinc_cos_coeffs(theta_sq)
    Phi = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return eye + b[..., None, None] * Phi + c[..., None, None] * (Phi @ Phi)


def so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse left Jacobian of SO(3), Taylor-guarded."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    small = theta_sq < _EPS
    safe_ts = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_ts)
    half = 0.5 * theta
    safe_sin = jnp.where(small, 1.0, jnp.sin(half))
    # cot term: (1 - θ/2 · cot(θ/2)) / θ², Taylor 1/12 + θ²/720 near zero
    cot_coeff = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * jnp.cos(half) / safe_sin) / safe_ts,
    )
    Phi = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    return eye - 0.5 * Phi + cot_coeff[..., None, None] * (Phi @ Phi)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3_exp(xi: jnp.ndarray):
    """Exponential map se(3) -> SE(3). xi (..., 6) = [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SE(3) -> se(3): returns (..., 6) = [rho, phi]."""
    phi = so3_log(R)
    Vinv = so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x):
    """Apply SE(3) to points x (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, x) + t


def se3_identity(batch_shape=(), dtype=jnp.float32):
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=dtype)
    return R, t


def se3_retract(R, t, xi):
    """Left-multiplicative retraction: exp(xi) ∘ (R, t) — the GN/LM update."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def se3_normalize(R):
    """Re-orthonormalize a rotation (Gram-Schmidt via QR-free cross products)."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True).clip(1e-12)
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / jnp.linalg.norm(y, axis=-1, keepdims=True).clip(1e-12)
    z = jnp.cross(x, y)
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# Sim(3) — needed by loop closing (Sim3 solver + essential-graph optimization,
# reference engine's LoopClosing; see SURVEY.md E8).
# ---------------------------------------------------------------------------


def sim3_exp(xi: jnp.ndarray):
    """Exponential map sim(3) -> Sim(3). xi (..., 7) = [rho, phi, sigma].

    Returns (R, t, s). Uses the closed-form W matrix (Strasdat's thesis) with
    Taylor guards on both θ and σ.
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)

    theta_sq = jnp.sum(phi * phi, axis=-1)
    small_th = theta_sq < _EPS
    theta = jnp.sqrt(jnp.where(small_th, 1.0, theta_sq))
    small_sg = jnp.abs(sigma) < 1e-5

    # Coefficients of W = A_ * I + B_ * Phi + C_ * Phi^2.
    a_coef = jnp.where(small_sg, 1.0 + sigma / 2.0, (s - 1.0) / jnp.where(small_sg, 1.0, sigma))

    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    denom = jnp.where(small_sg, 1.0, sigma * sigma + theta_sq)
    # generic σ, generic θ
    b_gen = (s * (sigma * sin_t - theta * cos_t) + theta) / (
        jnp.where(small_th, 1.0, theta) * denom
    )
    c_gen = (
        a_coef
        - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom
    ) / jnp.where(small_th, 1.0, theta_sq)
    # small θ limits (any σ): B -> s*... use Taylor in θ at fixed σ
    b_small_th = jnp.where(
        small_sg,
        1.0 / 2.0 + sigma / 3.0,
        (sigma * s - s + 1.0 + 0.0 * theta_sq) / jnp.where(small_sg, 1.0, sigma * sigma),
    )
    c_small_th = jnp.where(
        small_sg,
        1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0)
        / jnp.where(small_sg, 1.0, sigma * sigma * sigma),
    )
    # small σ, generic θ
    one_m_cos = 1.0 - cos_t
    b_small_sg = one_m_cos / jnp.where(small_th, 1.0, theta_sq)
    c_small_sg = (theta - sin_t) / jnp.where(small_th, 1.0, theta_sq * theta)

    B = jnp.where(small_th, b_small_th, jnp.where(small_sg, b_small_sg, b_gen))
    C = jnp.where(small_th, c_small_th, jnp.where(small_sg, c_small_sg, c_gen))

    Phi = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Phi.shape)
    W = a_coef[..., None, None] * eye + B[..., None, None] * Phi + C[..., None, None] * (
        Phi @ Phi
    )
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return R, t, s


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) ∘ (Rb, tb, sb); action x -> s R x + t."""
    return (
        Ra @ Rb,
        sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta,
        sa * sb,
    )


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_apply(R, t, s, x):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x) + t


def sim3_log(R, t, s):
    """Logarithm Sim(3) -> sim(3) via numerically robust W^{-1} solve."""
    phi = so3_log(R)
    sigma = jnp.log(s)
    # Rebuild W from (phi, sigma) and solve W rho = t.
    xi_probe = jnp.concatenate([jnp.zeros_like(phi), phi, sigma[..., None]], axis=-1)
    _, _, _ = sim3_exp(xi_probe)  # keeps the two implementations consistent
    W = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def _sim3_W(phi, sigma):
    xi = jnp.concatenate([jnp.zeros_like(phi), phi, sigma[..., None]], axis=-1)
    # Extract W by applying sim3_exp to basis vectors of rho.
    eye = jnp.eye(3, dtype=phi.dtype)
    cols = []
    for i in range(3):
        rho = jnp.broadcast_to(eye[i], phi.shape)
        xi_i = jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)
        _, t_i, _ = sim3_exp(xi_i)
        cols.append(t_i)
    del xi
    return jnp.stack(cols, axis=-1)
