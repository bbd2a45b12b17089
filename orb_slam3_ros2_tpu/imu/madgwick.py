"""Madgwick AHRS orientation filter (imu_filter_madgwick side-car parity).

The reference wires `imu_filter_madgwick` between the camera IMU stream and
rtabmap (`/root/reference/launch/rtabmap.launch.py:67-84`: consumes
`/orb_camera/imu`, publishes orientation-filled IMU on `/rtabmap/imu`,
`use_mag: false`, `world_frame: odom`, `publish_tf: true` — the
odom→base_link TF broadcast lives in runtime/ros_bridge.MadgwickImuNode,
which owns the ROS surface). This module is the JAX
equivalent: the gradient-descent IMU update from Madgwick's 2010 report,
expressed as a `jax.lax.scan` over a batch of samples so a whole buffered
window filters in one fused XLA launch, plus a small host-side streaming
wrapper for the live-ingest path.

Conventions: Hamilton quaternions `(w, x, y, z)`; the state `q` is
world-from-body (`v_world = R(q) @ v_body`), so a static sensor satisfies
`R(q)^T @ [0,0,1] == acc/|acc|`. Gyro in rad/s (body frame), accel in any
consistent unit (only its direction is used).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = [
    "quat_mul", "quat_normalize", "quat_to_rotmat", "quat_from_accel",
    "madgwick_step", "madgwick_filter", "MadgwickFilter",
]


def quat_mul(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product p ⊗ q, both (..., 4) as (w, x, y, z)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], axis=-1)


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), eps)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) wxyz → (..., 3, 3) with v_world = R @ v_body."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def quat_from_accel(acc: jnp.ndarray) -> jnp.ndarray:
    """Tilt-only initial quaternion from one accelerometer sample.

    Returns the shortest-arc world-from-body rotation taking the measured
    gravity direction (body) onto +z (world); yaw is unobservable and left
    at zero. Falls back to identity for a near-zero sample.
    """
    a = acc / jnp.maximum(jnp.linalg.norm(acc), 1e-12)
    # shortest arc from a to e3: q = [1 + a·e3, a × e3] normalized
    w = 1.0 + a[2]
    xyz = jnp.stack([a[1], -a[0], jnp.zeros_like(a[0])])
    q = jnp.concatenate([w[None], xyz])
    ok = jnp.linalg.norm(acc) > 1e-8
    # antipodal (a ≈ -e3): pick a 180° roll
    deg = w < 1e-6
    q = jnp.where(deg, jnp.array([0.0, 1.0, 0.0, 0.0]), quat_normalize(q))
    return jnp.where(ok, q, jnp.array([1.0, 0.0, 0.0, 0.0]))


def madgwick_step(q: jnp.ndarray, gyro: jnp.ndarray, acc: jnp.ndarray,
                  dt: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """One IMU (gyro+accel) Madgwick update of a single quaternion."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    # gyro quaternion derivative: 0.5 * q ⊗ (0, ω)
    omega = jnp.concatenate([jnp.zeros((1,), q.dtype), gyro])
    q_dot = 0.5 * quat_mul(q, omega)

    # gradient-descent correction toward R(q)^T e3 == acc/|acc|
    anorm = jnp.linalg.norm(acc)
    a = acc / jnp.maximum(anorm, 1e-12)
    f = jnp.stack([
        2.0 * (qx * qz - qw * qy) - a[0],
        2.0 * (qw * qx + qy * qz) - a[1],
        1.0 - 2.0 * (qx * qx + qy * qy) - a[2],
    ])
    J = jnp.array([
        [-2.0 * qy, 2.0 * qz, -2.0 * qw, 2.0 * qx],
        [2.0 * qx, 2.0 * qw, 2.0 * qz, 2.0 * qy],
        [0.0, -4.0 * qx, -4.0 * qy, 0.0],
    ], dtype=q.dtype)
    grad = J.T @ f
    gnorm = jnp.linalg.norm(grad)
    use_acc = anorm > 1e-8
    corr = jnp.where(use_acc & (gnorm > 1e-12),
                     beta * grad / jnp.maximum(gnorm, 1e-12), 0.0)
    return quat_normalize(q + (q_dot - corr) * dt)


@functools.partial(jax.jit, static_argnames=())
def madgwick_filter(gyro: jnp.ndarray, acc: jnp.ndarray, dts: jnp.ndarray,
                    q0: jnp.ndarray, beta: jnp.ndarray,
                    mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Filter a batch of N samples in one scan; returns (N, 4) quaternions.

    `dts[i]` is the interval ending at sample i. Masked-out samples leave
    the state unchanged (fixed-capacity host buffers pad with mask=False).
    """
    n = gyro.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    dts = jnp.broadcast_to(dts, (n,))

    def step(q, inp):
        g, a, dt, m = inp
        q_new = madgwick_step(q, g, a, dt, beta)
        q_new = jnp.where(m, q_new, q)
        return q_new, q_new

    _, qs = jax.lax.scan(step, q0, (gyro, acc, dts, mask))
    return qs


class MadgwickFilter:
    """Streaming host wrapper: feed sample windows, read the latest pose.

    Mirrors the `imu_filter_madgwick` node's role in the live pipeline —
    the bridge buffers IMU between publish ticks and filters each window
    with one jitted scan (no per-sample dispatch at 200 Hz).
    """

    def __init__(self, beta: float = 0.1, dtype=jnp.float32):
        self.beta = float(beta)
        self.dtype = dtype
        self.q: Optional[jnp.ndarray] = None
        self._t_prev: Optional[float] = None

    def update(self, gyro, acc, times):
        """Filter one window; arrays (N,3),(N,3),(N,). Returns (N,4) quats."""
        import numpy as np

        gyro = jnp.asarray(gyro, self.dtype)
        acc = jnp.asarray(acc, self.dtype)
        times = np.asarray(times, float)
        if self.q is None:
            self.q = quat_from_accel(acc[0]).astype(self.dtype)
            self._t_prev = float(times[0])
        dts = np.diff(np.concatenate([[self._t_prev], times]))
        dts = np.clip(dts, 0.0, 0.5)  # tolerate gaps/replays
        qs = madgwick_filter(gyro, acc, jnp.asarray(dts, self.dtype),
                             self.q, jnp.asarray(self.beta, self.dtype))
        self.q = qs[-1]
        self._t_prev = float(times[-1])
        return qs

    @property
    def rotation(self) -> Optional[jnp.ndarray]:
        """Latest world-from-body rotation matrix, or None before any data."""
        return None if self.q is None else quat_to_rotmat(self.q)
