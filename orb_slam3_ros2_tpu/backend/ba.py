"""Bundle adjustment with Schur-complement reduction (E6/E11).

Replaces the reference's g2o-based `Optimizer::LocalBundleAdjustment` /
`GlobalBundleAdjustemnt` (LM over SE3 keyframe vertices + 3-D landmark
vertices with Huber-robust mono edges [upstream; the fork exposes its VIBA
progress through `GetInertialBA1/2`,
`/root/reference/src/imu_mono_realsense.cpp:485-495`]).

Design (SURVEY.md §7): the problem is a fixed-capacity dense
masked block — K poses × L landmarks with an observation mask — instead of a
pointer graph. One LM iteration runs through the matmul-shaped elimination
core (`backend/schur.py`): per-landmark 3×3 Cholesky in closed form, the
whitened cross term `V = W·L⁻ᵀ` built once elementwise, and the reduced
camera system formed as ONE (6K, 3L) @ (3L, 6K) matmul — followed by a
dense 6K×6K solve and two matvecs for the landmark back-substitution.
Landmark elimination is exact. Gauge freedom is fixed by a large diagonal
prior on `fixed_mask` poses (the reference fixes its anchor keyframes the
same way, by marking vertices fixed). The same core distributes over a
device mesh by sharding L — see parallel/sharded_ba.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.backend import residuals as res
from orb_slam3_ros2_tpu.backend import schur
from orb_slam3_ros2_tpu.geom import lie

# math.sqrt, NOT jnp: importing this module must not initialize a JAX
# backend or run a device computation.
HUBER = math.sqrt(res.CHI2_MONO)
FIXED_PRIOR = 1e12  # diagonal prior that pins gauge-fixed poses


class BAProblem(NamedTuple):
    """Dense masked BA problem. K poses, L landmarks."""

    R: jnp.ndarray  # (K, 3, 3) T_cw rotations
    t: jnp.ndarray  # (K, 3)
    X: jnp.ndarray  # (L, 3) world points
    uv: jnp.ndarray  # (K, L, 2) undistorted pixel observations
    w: jnp.ndarray  # (K, L) information weight (inv_sigma2 * obs_mask); 0 = no obs
    fixed: jnp.ndarray  # (K,) bool — poses held constant (gauge anchors)
    point_valid: jnp.ndarray  # (L,) bool


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    X: jnp.ndarray
    cost: jnp.ndarray  # robust cost after the last accepted step
    inlier_w: jnp.ndarray  # (K, L) final effective weights (post chi² gate)


def _robust_terms(p: BAProblem, fx, fy, cx, cy, w_active):
    """Residuals/Jacobians/weights for the current state."""
    proj = res.reproj_residual(
        p.R[:, None], p.t[:, None], p.X[None, :], p.uv, fx, fy, cx, cy
    )
    r2 = jnp.sum(proj.r**2, axis=-1) * w_active
    hw = res.huber_weight(r2, HUBER)
    ww = w_active * hw * (proj.depth > 0.05)
    cost = jnp.sum(
        jnp.where(
            r2 <= HUBER * HUBER,
            r2,
            2.0 * HUBER * jnp.sqrt(jnp.maximum(r2, 1e-12)) - HUBER * HUBER,
        )
        * (w_active > 0)
    )
    return proj, ww, cost


def _cost_only(p: BAProblem, fx, fy, cx, cy, w_active, R, t, X):
    q = p._replace(R=R, t=t, X=X)
    _, _, cost = _robust_terms(q, fx, fy, cx, cy, w_active)
    return cost


def ba_iteration(p: BAProblem, fx, fy, cx, cy, w_active, lam):
    """One damped GN (LM) step; returns proposed (R, t, X).

    The landmark elimination runs through the matmul-shaped core
    (`backend/schur.py`): one (6K, 3L) @ (3L, 6K) matmul forms the reduced
    camera system instead of small-block einsums (r3 profile: 0.7% SoL)."""
    terms = schur.schur_reduce(
        p.R, p.t, p.X, p.uv, w_active, fx, fy, cx, cy, lam
    )
    dxc = schur.solve_cameras(
        terms.Hcc_p, terms.S_off, terms.rhs_p, p.fixed, lam, FIXED_PRIOR
    )
    dxl = schur.back_substitute(terms, dxc, p.point_valid)

    R_new, t_new = lie.se3_retract(p.R, p.t, dxc)
    R_new = lie.se3_normalize(R_new)
    X_new = p.X + dxl
    return R_new, t_new, X_new


def bundle_adjust(
    p: BAProblem,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    n_iters: int = 10,
    chi2_th: float = res.CHI2_MONO,
    reclassify_every: int = 5,
) -> BAResult:
    """Robust LM bundle adjustment over a fixed-size window.

    Static iteration count under `lax.scan`; chi² outlier gating is refreshed
    every `reclassify_every` iterations (mirrors the reference's two-stage
    local BA: optimize 5, drop outliers, optimize 10 [upstream]).
    """
    w_base = p.w

    def step(carry, it):
        R, t, X, lam, w_active = carry

        # periodic chi² re-classification — never before the first iteration
        # (optimize on all observations first, then gate, like the reference)
        w_active = jax.lax.cond(
            (it > 0) & ((it % reclassify_every) == 0),
            lambda: schur.refresh_weights(R, t, X, p.uv, w_base,
                                          fx, fy, cx, cy, chi2_th),
            lambda: w_active,
        )

        # one linearization per iteration: schur_reduce returns the robust
        # cost at the linearization point alongside the reduced system
        terms = schur.schur_reduce(
            R, t, X, p.uv, w_active, fx, fy, cx, cy, lam
        )
        dxc = schur.solve_cameras(
            terms.Hcc_p, terms.S_off, terms.rhs_p, p.fixed, lam, FIXED_PRIOR
        )
        dxl = schur.back_substitute(terms, dxc, p.point_valid)
        R_new, t_new = lie.se3_retract(R, t, dxc)
        R_new = lie.se3_normalize(R_new)
        X_new = X + dxl
        cost0 = terms.cost0
        cost1 = schur.robust_cost(R_new, t_new, X_new, p.uv, w_active,
                                  fx, fy, cx, cy)
        better = cost1 < cost0
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        X = jnp.where(better, X_new, X)
        lam = jnp.where(better, lam * 0.3, lam * 5.0).clip(1e-9, 1e3)
        return (R, t, X, lam, w_active), cost1

    (R, t, X, lam, w_active), costs = jax.lax.scan(
        step, (p.R, p.t, p.X, jnp.asarray(1e-4, jnp.float32), w_base),
        jnp.arange(n_iters),
    )
    cost = schur.robust_cost(R, t, X, p.uv, w_active, fx, fy, cx, cy)
    return BAResult(R=R, t=t, X=X, cost=cost, inlier_w=w_active)
