"""Visual-inertial initialization (VIBA1 stage, E7).

Reference behavior: after a mono map exists, ORB-SLAM3 runs inertial-only
MAP optimization solving {scale, gravity direction, per-KF velocities, gyro
+ accel biases} with visual poses fixed, then upgrades the map and later
re-runs joint visual-inertial BA (VIBA2). The wrapper surfaces these stage
gates as `GetInertialBA1/GetInertialBA2`
(`/root/reference/src/imu_mono_realsense.cpp:485-495` [api]; stage semantics
`README.md:118-121`).

Design: the whole problem is one flat parameter vector
θ = [log s, θ_g(2), v(K·3), bg(3), ba(3)] and one residual vector (all
preintegration intervals whitened by their preintegration covariance +
bias priors). GN with `jax.jacfwd` — the problem is tiny (tens of params),
so exact dense autodiff Jacobians beat hand-derivation and stay correct as
the residual evolves. Fixed iteration count under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.imu import preintegration as pre_mod

G0 = jnp.array([0.0, 0.0, -9.81])


class VIInitResult(NamedTuple):
    scale: jnp.ndarray  # ()
    R_wg: jnp.ndarray  # (3, 3) gravity-aligning rotation: g_w = R_wg @ (0,0,-9.81)
    v: jnp.ndarray  # (K, 3) body velocities (metric)
    bg: jnp.ndarray  # (3,)
    ba: jnp.ndarray  # (3,)
    cost: jnp.ndarray  # () final whitened cost
    # host float default: a module-level jnp array would initialize the JAX
    # backend at import time; vi_init always fills this with a traced value
    scale_var: jnp.ndarray | float = 0.0  # posterior var of log s
    # (from the GN Hessian at the optimum — the scale observability of
    # THIS window; callers weight how much of the correction to apply)


def _unpack(theta, K):
    log_s = theta[0]
    th_g = theta[1:3]
    v = theta[3 : 3 + 3 * K].reshape(K, 3)
    bg = theta[3 + 3 * K : 6 + 3 * K]
    ba = theta[6 + 3 * K : 9 + 3 * K]
    return log_s, th_g, v, bg, ba


def _bootstrap(pres, R_wb, p_wb, fix_scale, n_bg_iters: int = 6):
    """Closed-form-style starting point (upstream runs the same staged
    schedule: gyro bias from rotation-only alignment, then a linear solve
    for scale/gravity/velocities [Campos inertial-only init]).

    Stage A: GN on bg alone over the rotation residuals (near-linear).
    Stage B: with bg fixed, the Δv/Δp preintegration equations are LINEAR in
    (s, g_w, v_0..v_{K-1}) — one dense lstsq. Starting the MAP GN here keeps
    it in the right basin (from θ=0 it can settle 5°+ off in gravity).
    """
    K = R_wb.shape[0]
    n_int = K - 1

    def rot_residuals(bg):
        def one(i):
            pre_i = jax.tree_util.tree_map(lambda x: x[i], pres)
            dR = pre_i.dR @ lie.so3_exp(pre_i.JRg @ (bg - pre_i.bg))
            return lie.so3_log(dR.T @ R_wb[i].T @ R_wb[i + 1])

        return jax.vmap(one)(jnp.arange(n_int)).reshape(-1)

    def bg_step(bg, _):
        r = rot_residuals(bg)
        J = jax.jacfwd(rot_residuals)(bg)
        H = J.T @ J + 1e-8 * jnp.eye(3)
        bg_new = bg - jnp.linalg.solve(H, J.T @ r)
        return bg_new, None

    bg0, _ = jax.lax.scan(bg_step, jnp.zeros(3), None, length=n_bg_iters)

    # stage B: rows per interval — unknown x = [s, g(3), v(3K)]
    def corrected(i):
        pre_i = jax.tree_util.tree_map(lambda x: x[i], pres)
        _, dv, dp = pre_mod.bias_corrected(pre_i, bg0, pre_i.ba)
        return dv, dp, pre_i.dt

    dv_all, dp_all, dt_all = jax.vmap(corrected)(jnp.arange(n_int))
    D = 4 + 3 * K

    def rows(i):
        dt = dt_all[i]
        Ri = R_wb[i]
        # r_p: s·Δp_vis − v_i·dt − ½dt²·g = R_i @ dp
        Ap = jnp.zeros((3, D))
        Ap = Ap.at[:, 0].set(p_wb[i + 1] - p_wb[i])
        Ap = Ap.at[:, 1:4].set(-0.5 * dt * dt * jnp.eye(3))
        Ap = jax.lax.dynamic_update_slice(
            Ap, -dt * jnp.eye(3), (0, 4 + 3 * i)
        )
        bp = Ri @ dp_all[i]
        # r_v: v_j − v_i − dt·g = R_i @ dv
        Av = jnp.zeros((3, D))
        Av = Av.at[:, 1:4].set(-dt * jnp.eye(3))
        Av = jax.lax.dynamic_update_slice(
            Av, -jnp.eye(3), (0, 4 + 3 * i)
        )
        Av = jax.lax.dynamic_update_slice(
            Av, jnp.eye(3), (0, 4 + 3 * (i + 1))
        )
        bv = Ri @ dv_all[i]
        return jnp.concatenate([Ap, Av]), jnp.concatenate([bp, bv])

    A, b = jax.vmap(rows)(jnp.arange(n_int))
    A = A.reshape(-1, D)
    b = b.reshape(-1)
    if fix_scale:
        # pin s = 1: move the s column to the RHS
        b = b - A[:, 0]
        A = A.at[:, 0].set(0.0)
    # mild Tikhonov keeps the few-KF case well-posed
    H = A.T @ A + 1e-6 * jnp.eye(D)
    x = jnp.linalg.solve(H, A.T @ b)
    s0 = jnp.where(fix_scale, 1.0, jnp.clip(x[0], 1e-3, 1e3))
    g0 = x[1:4]
    v0 = x[4:].reshape(K, 3)

    # gravity direction → minimal 2-DOF rotation taking (0,0,-1) to ĝ
    ghat = g0 / jnp.maximum(jnp.linalg.norm(g0), 1e-9)
    z = jnp.array([0.0, 0.0, -1.0])
    axis = jnp.cross(z, ghat)
    sin_a = jnp.linalg.norm(axis)
    cos_a = jnp.dot(z, ghat)
    angle = jnp.arctan2(sin_a, cos_a)
    axis = axis / jnp.maximum(sin_a, 1e-9)
    th_g = (axis * angle)[:2]
    return jnp.log(s0), th_g, v0, bg0


def vi_init(
    pres: pre_mod.Preintegrated,  # stacked pytree, leading dim K-1 (intervals)
    R_wb: jnp.ndarray,  # (K, 3, 3) visual body rotations (world arbitrary)
    p_wb: jnp.ndarray,  # (K, 3) visual body positions (up to scale)
    prior_bg: float = 1e2,
    prior_ba: float = 1e10,
    n_iters: int = 25,
    fix_scale: bool = False,
    bg_center: jnp.ndarray | None = None,
    ba_center: jnp.ndarray | None = None,
) -> VIInitResult:
    """Inertial-only MAP estimation with visual poses fixed.

    `pres` is a Preintegrated pytree whose leaves carry a leading (K-1) dim
    (one interval per consecutive keyframe pair). For stereo/rectified input
    `fix_scale=True` pins log s = 0 (reference does the same [upstream]).

    The default accel-bias prior is essentially rigid (upstream uses
    priorA=1e10 in monocular InitializeIMU): with the low excitation typical
    of an init window, a free ba is confounded with scale and the scale
    estimate collapses low. Pass a looser prior for refinement stages, with
    `bg/ba_center` at the running estimates.
    """
    K = R_wb.shape[0]
    bg_c = jnp.zeros(3) if bg_center is None else bg_center
    ba_c = jnp.zeros(3) if ba_center is None else ba_center

    # whitening: W = chol(info)ᵀ so ||W r||² = rᵀ Σ⁻¹ r
    info = jax.vmap(pre_mod.information)(pres)
    Wmat = jnp.linalg.cholesky(
        0.5 * (info + jnp.swapaxes(info, -1, -2))
        + 1e-6 * jnp.eye(9)[None]
    )

    def residuals(theta):
        log_s, th_g, v, bg, ba = _unpack(theta, K)
        s = jnp.where(fix_scale, 1.0, jnp.exp(log_s))
        R_wg = lie.so3_exp(jnp.concatenate([th_g, jnp.zeros(1)]))
        g_w = R_wg @ G0

        def one(i):
            pre_i = jax.tree_util.tree_map(lambda x: x[i], pres)
            r = pre_mod.residual(
                pre_i,
                R_wb[i], s * p_wb[i], v[i],
                R_wb[i + 1], s * p_wb[i + 1], v[i + 1],
                bg, ba, scale=1.0, g_w=g_w,
            )
            return jnp.swapaxes(Wmat[i], 0, 1) @ r

        r_all = jax.vmap(one)(jnp.arange(K - 1)).reshape(-1)
        r_prior = jnp.concatenate(
            [jnp.sqrt(prior_bg) * (bg - bg_c),
             jnp.sqrt(prior_ba) * (ba - ba_c)]
        )
        return jnp.concatenate([r_all, r_prior])

    log_s0, th_g0, v0, bg0 = _bootstrap(pres, R_wb, p_wb, fix_scale)
    theta0 = jnp.concatenate(
        [log_s0[None], th_g0, v0.reshape(-1), bg0, jnp.zeros(3)]
    )

    def gn_step(theta, _):
        r = residuals(theta)
        J = jax.jacfwd(residuals)(theta)
        H = J.T @ J + 1e-6 * jnp.eye(theta.shape[0])
        b = J.T @ r
        dx = -jnp.linalg.solve(H, b)
        # simple step-halving safeguard: accept only if cost decreases
        def cost(th):
            rr = residuals(th)
            return jnp.sum(rr * rr)
        c0 = cost(theta)
        cands = jnp.stack([theta + dx, theta + 0.5 * dx, theta + 0.25 * dx])
        costs = jax.vmap(cost)(cands)
        best = jnp.argmin(costs)
        theta = jnp.where(costs[best] < c0, cands[best], theta)
        return theta, costs[best]

    theta, costs = jax.lax.scan(gn_step, theta0, None, length=n_iters)
    log_s, th_g, v, bg, ba = _unpack(theta, K)
    r = residuals(theta)
    # posterior variance of log s: [H^{-1}]_00 at the optimum (whitened
    # residuals => unit-information Gauss-Markov), inflated by the reduced
    # chi^2 so model-mismatch windows (bad visual poses) report themselves
    J = jax.jacfwd(residuals)(theta)
    H = J.T @ J + 1e-9 * jnp.eye(theta.shape[0])
    var0 = jnp.linalg.inv(H)[0, 0]
    dof = jnp.maximum(r.shape[0] - theta.shape[0], 1)
    chi2_red = jnp.maximum(jnp.sum(r * r) / dof, 1.0)
    return VIInitResult(
        scale=jnp.where(fix_scale, 1.0, jnp.exp(log_s)),
        R_wg=lie.so3_exp(jnp.concatenate([th_g, jnp.zeros(1)])),
        v=v,
        bg=bg,
        ba=ba,
        cost=jnp.sum(r * r),
        scale_var=var0 * chi2_red,
    )
