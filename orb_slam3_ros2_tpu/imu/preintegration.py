"""IMU preintegration (E7): scan-based Forster-style preintegrated deltas
with first-order bias Jacobians and noise-covariance propagation.

Reference surface: `ORB_SLAM3::IMU::Point` measurements fed to
`TrackMonocular` (`/root/reference/src/imu_mono_realsense.cpp:334` [api]),
noise/bias-walk parameters `IMU.{NoiseGyro,NoiseAcc,GyroWalk,AccWalk,
Frequency}` and extrinsics `IMU.T_b_c1`
(`/root/reference/config/Monocular-Inertial/EuRoC.yaml:35-49`). The engine
preintegrates gyro/accel between frames/keyframes and uses the deltas as
relative-motion factors in visual-inertial BA [upstream `IMU::Preintegrated`].

Design: the whole measurement batch integrates in one `jax.lax.scan`
(static max length, masked tail), producing a `Preintegrated` pytree that is
itself a valid scan carry — so N keyframe intervals preintegrate as one
vmapped scan. Residual/Jacobian helpers below feed the VI initializer and
visual-inertial BA.

Conventions: body frame b; world gravity g_w = (0,0,-9.81); states are
(R_wb, p_w, v_w, bg, ba). Accelerometer measures specific force
a_m = R_bw (a_w - g_w) + ba + noise.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam3_ros2_tpu.geom import lie

GRAVITY_W = jnp.array([0.0, 0.0, -9.81])


class Preintegrated(NamedTuple):
    """Preintegrated deltas over [t_i, t_j] at linearization biases (bg, ba)."""

    dR: jnp.ndarray  # (3, 3)
    dv: jnp.ndarray  # (3,)
    dp: jnp.ndarray  # (3,)
    dt: jnp.ndarray  # () total time
    # bias Jacobians (first order, Forster eq. 44)
    JRg: jnp.ndarray  # (3, 3) ∂ΔR/∂bg
    Jvg: jnp.ndarray  # (3, 3) ∂Δv/∂bg
    Jva: jnp.ndarray  # (3, 3) ∂Δv/∂ba
    Jpg: jnp.ndarray  # (3, 3) ∂Δp/∂bg
    Jpa: jnp.ndarray  # (3, 3) ∂Δp/∂ba
    cov: jnp.ndarray  # (9, 9) covariance of (δφ, δv, δp)
    bg: jnp.ndarray  # (3,) linearization gyro bias
    ba: jnp.ndarray  # (3,) linearization accel bias


def identity_preintegrated(bg=None, ba=None) -> Preintegrated:
    z3 = jnp.zeros(3)
    z33 = jnp.zeros((3, 3))
    return Preintegrated(
        dR=jnp.eye(3), dv=z3, dp=z3, dt=jnp.zeros(()),
        JRg=z33, Jvg=z33, Jva=z33, Jpg=z33, Jpa=z33,
        cov=jnp.zeros((9, 9)),
        bg=z3 if bg is None else bg, ba=z3 if ba is None else ba,
    )


def integrate(
    pre: Preintegrated,
    gyro: jnp.ndarray,  # (M, 3) raw gyro samples
    acc: jnp.ndarray,  # (M, 3) raw accel samples
    dts: jnp.ndarray,  # (M,) per-sample integration intervals
    mask: jnp.ndarray,  # (M,) bool — padded tail entries are skipped
    noise_gyro: float = 1.7e-4,
    noise_acc: float = 2.0e-3,
) -> Preintegrated:
    """Integrate a (masked, fixed-length) batch of samples into `pre`.

    Noise densities are continuous-time (rad/s/√Hz, m/s²/√Hz) as in the
    settings YAMLs; discrete covariance per step uses σ²/dt.
    """

    def step(c: Preintegrated, inp):
        w, a, dt, m = inp
        dt = jnp.where(m, dt, 0.0)
        wd = w - c.bg
        ad = a - c.ba
        dRk = lie.so3_exp(wd * dt)
        Jr = lie.so3_left_jacobian(-wd * dt)  # right Jacobian of exp(wd dt)

        a_rot = c.dR @ ad
        hat_a = lie.hat(ad)

        # covariance propagation (Forster eq. A.7-A.9) for (δφ, δv, δp)
        A = jnp.zeros((9, 9))
        A = A.at[0:3, 0:3].set(dRk.T)
        A = A.at[3:6, 0:3].set(-c.dR @ hat_a * dt)
        A = A.at[3:6, 3:6].set(jnp.eye(3))
        A = A.at[6:9, 0:3].set(-0.5 * c.dR @ hat_a * dt * dt)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)
        A = A.at[6:9, 6:9].set(jnp.eye(3))
        B = jnp.zeros((9, 6))
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(c.dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * c.dR * dt * dt)
        sdt = jnp.where(dt > 0, 1.0 / jnp.maximum(dt, 1e-9), 0.0)
        Q = jnp.zeros((6, 6))
        Q = Q.at[0:3, 0:3].set(jnp.eye(3) * noise_gyro**2 * sdt)
        Q = Q.at[3:6, 3:6].set(jnp.eye(3) * noise_acc**2 * sdt)
        cov = A @ c.cov @ A.T + B @ Q @ B.T

        # bias Jacobians (update BEFORE dR so they use pre-update dR)
        Jpg = c.Jpg + c.Jvg * dt - 0.5 * c.dR @ hat_a @ c.JRg * dt * dt
        Jpa = c.Jpa + c.Jva * dt - 0.5 * c.dR * dt * dt
        Jvg = c.Jvg - c.dR @ hat_a @ c.JRg * dt
        Jva = c.Jva - c.dR * dt
        JRg = dRk.T @ c.JRg - Jr * dt

        dp = c.dp + c.dv * dt + 0.5 * a_rot * dt * dt
        dv = c.dv + a_rot * dt
        dR = c.dR @ dRk

        new = Preintegrated(
            dR=dR, dv=dv, dp=dp, dt=c.dt + dt,
            JRg=JRg, Jvg=Jvg, Jva=Jva, Jpg=Jpg, Jpa=Jpa,
            cov=cov, bg=c.bg, ba=c.ba,
        )
        # masked step: keep previous state entirely
        out = jax.tree_util.tree_map(
            lambda n, o: jnp.where(m, n, o), new, c
        )
        return out, None

    out, _ = jax.lax.scan(step, pre, (gyro, acc, dts, mask))
    return out


def preintegrate(gyro, acc, dts, mask, bg=None, ba=None,
                 noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3
                 ) -> Preintegrated:
    pre = identity_preintegrated(bg, ba)
    return integrate(pre, gyro, acc, dts, mask, noise_gyro, noise_acc)


def merge(pre1: Preintegrated, pre2: Preintegrated) -> Preintegrated:
    """Compose two consecutive preintegrated intervals into one.

    Used when a redundant keyframe between the intervals is culled — the
    equivalent of the reference engine's `IMU::Preintegrated::MergePrevious`
    [upstream]. First-order composition of deltas, bias Jacobians, and noise
    covariance; the result is linearized at `pre1`'s biases (callers keep
    consecutive intervals at the same running bias estimate).
    """
    dR1, dv1, dp1, dt2 = pre1.dR, pre1.dv, pre1.dp, pre2.dt
    # deltas
    dR = dR1 @ pre2.dR
    dv = dv1 + dR1 @ pre2.dv
    dp = dp1 + dv1 * dt2 + dR1 @ pre2.dp
    # bias Jacobians: perturb bg/ba through both intervals
    # dR(b+δ) ≈ dR exp((dR2ᵀ JRg1 + JRg2) δ)
    JRg = pre2.dR.T @ pre1.JRg + pre2.JRg
    # exp(JRg1 δ) x ≈ x - hat(x) JRg1 δ
    Jvg = pre1.Jvg + dR1 @ pre2.Jvg - dR1 @ lie.hat(pre2.dv) @ pre1.JRg
    Jva = pre1.Jva + dR1 @ pre2.Jva
    Jpg = (pre1.Jpg + pre1.Jvg * dt2 + dR1 @ pre2.Jpg
           - dR1 @ lie.hat(pre2.dp) @ pre1.JRg)
    Jpa = pre1.Jpa + pre1.Jva * dt2 + dR1 @ pre2.Jpa
    # covariance: δ_combined = A1 δ1 + A2 δ2 for state (δφ, δv, δp)
    I3 = jnp.eye(3)
    Z3 = jnp.zeros((3, 3))
    A1 = jnp.block([
        [pre2.dR.T, Z3, Z3],
        [-dR1 @ lie.hat(pre2.dv), I3, Z3],
        [-dR1 @ lie.hat(pre2.dp), I3 * dt2, I3],
    ])
    A2 = jnp.block([
        [I3, Z3, Z3],
        [Z3, dR1, Z3],
        [Z3, Z3, dR1],
    ])
    cov = A1 @ pre1.cov @ A1.T + A2 @ pre2.cov @ A2.T
    return Preintegrated(
        dR=dR, dv=dv, dp=dp, dt=pre1.dt + dt2,
        JRg=JRg, Jvg=Jvg, Jva=Jva, Jpg=Jpg, Jpa=Jpa,
        cov=cov, bg=pre1.bg, ba=pre1.ba,
    )


def bias_corrected(pre: Preintegrated, bg: jnp.ndarray, ba: jnp.ndarray):
    """First-order bias-corrected deltas at new biases (bg, ba)."""
    dbg = bg - pre.bg
    dba = ba - pre.ba
    dR = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dv = pre.dv + pre.Jvg @ dbg + pre.Jva @ dba
    dp = pre.dp + pre.Jpg @ dbg + pre.Jpa @ dba
    return dR, dv, dp


def residual(
    pre: Preintegrated,
    R_i: jnp.ndarray, p_i: jnp.ndarray, v_i: jnp.ndarray,
    R_j: jnp.ndarray, p_j: jnp.ndarray, v_j: jnp.ndarray,
    bg: jnp.ndarray, ba: jnp.ndarray,
    scale: jnp.ndarray | float = 1.0,
    g_w: jnp.ndarray = GRAVITY_W,
) -> jnp.ndarray:
    """9-dim preintegration residual (r_ΔR, r_Δv, r_Δp); Forster eq. 45.

    `scale` multiplies translations/velocities — used by the VI initializer
    where the visual map is metric up to scale (VIBA1, SURVEY.md E7).
    """
    dR, dv, dp = bias_corrected(pre, bg, ba)
    dt = pre.dt
    r_R = lie.so3_log(dR.T @ R_i.T @ R_j)
    r_v = R_i.T @ (scale * (v_j - v_i) - g_w * dt) - dv
    r_p = R_i.T @ (
        scale * (p_j - p_i - v_i * dt) - 0.5 * g_w * dt * dt
    ) - dp
    return jnp.concatenate([r_R, r_v, r_p])


def information(pre: Preintegrated, eps: float = 1e-8) -> jnp.ndarray:
    """(9, 9) information matrix = cov⁻¹ (regularized)."""
    return jnp.linalg.inv(pre.cov + eps * jnp.eye(9))
