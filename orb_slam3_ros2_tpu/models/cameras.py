"""Camera models: PinHole (radtan), Rectified, KannalaBrandt8 (fisheye).

Fixed-shape equivalent of the reference engine's `GeometricCamera` hierarchy
(SURVEY.md E2). Model names and parameter layout follow the settings-YAML
surface observable in the snapshot:

* ``Camera.type: "PinHole"`` with fx fy cx cy + k1 k2 p1 p2 [k3]
  (`/root/reference/config/Monocular-Inertial/EuRoC.yaml:8-23`),
* ``Camera.type: "Rectified"`` with fx fy cx cy and a stereo baseline
  ``Stereo.b`` (`/root/reference/config/Stereo/RealSense_D435i.yaml:8-16`),
* ``Camera.type: "KannalaBrandt8"`` with fx fy cx cy + k1..k4 equidistant
  coefficients (`/root/reference/config/Stereo/TUM-VI.yaml:8-32`).

Instead of a virtual-dispatch class tree, a camera is a plain dataclass of
static metadata plus a parameter vector; `project` / `unproject` are pure
functions broadcasting over leading batch dims, so they vmap over landmarks
and keyframes and stay inside `jit`. Jacobians come from `jax.jacfwd` at use
sites or the closed forms below for the hot paths.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax.numpy as jnp


class CameraModel(enum.IntEnum):
    PINHOLE = 0  # radtan distortion (k1, k2, p1, p2, k3)
    RECTIFIED = 1  # no distortion
    KANNALA_BRANDT8 = 2  # equidistant fisheye (k1..k4)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description. `params` layout:

    [fx, fy, cx, cy, d0..d4] — d are distortion coefficients (meaning depends
    on model; unused entries zero). Width/height are static ints so any array
    shapes derived from them are compile-time constants.
    """

    model: CameraModel
    params: Tuple[float, ...]  # length 9
    width: int
    height: int
    fps: float = 30.0
    baseline: float = 0.0  # Stereo.b for Rectified stereo; 0 for mono

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    @property
    def K(self) -> jnp.ndarray:
        fx, fy, cx, cy = self.params[:4]
        return jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=jnp.float32)

    def param_array(self) -> jnp.ndarray:
        return jnp.asarray(self.params, dtype=jnp.float32)


def make_camera(model: str, fx, fy, cx, cy, dist=(), width=640, height=480,
                fps=30.0, baseline=0.0) -> Camera:
    d = tuple(dist) + (0.0,) * (5 - len(dist))
    m = {
        "PinHole": CameraModel.PINHOLE,
        "Rectified": CameraModel.RECTIFIED,
        "KannalaBrandt8": CameraModel.KANNALA_BRANDT8,
    }[model]
    return Camera(model=m, params=(float(fx), float(fy), float(cx), float(cy)) + d,
                  width=int(width), height=int(height), fps=float(fps),
                  baseline=float(baseline))


# ---------------------------------------------------------------------------
# Projection — pure functions of (params, x_cam). Dispatch is static (Python)
# on camera.model, so each config compiles exactly one branch.
# ---------------------------------------------------------------------------


def _project_pinhole(p: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    z = jnp.where(jnp.abs(x[..., 2]) < 1e-8, 1e-8, x[..., 2])
    a = x[..., 0] / z
    b = x[..., 1] / z
    r2 = a * a + b * b
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = a * radial + 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
    yd = b * radial + p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
    return jnp.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def _project_rectified(p: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    z = jnp.where(jnp.abs(x[..., 2]) < 1e-8, 1e-8, x[..., 2])
    return jnp.stack(
        [fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], axis=-1
    )


def _project_kb8(p: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    r = jnp.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2).clip(1e-12)
    theta = jnp.arctan2(r, x[..., 2])
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return jnp.stack(
        [fx * scale * x[..., 0] + cx, fy * scale * x[..., 1] + cy], axis=-1
    )


def project(cam: Camera, x_cam: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame points (..., 3) to pixels (..., 2)."""
    p = cam.param_array()
    if cam.model == CameraModel.PINHOLE:
        return _project_pinhole(p, x_cam)
    if cam.model == CameraModel.RECTIFIED:
        return _project_rectified(p, x_cam)
    return _project_kb8(p, x_cam)


# ---------------------------------------------------------------------------
# Unprojection: pixel -> unit-z ray (a, b, 1). Distorted models invert via a
# fixed number of Newton iterations — static trip count keeps it jit-friendly.
# ---------------------------------------------------------------------------


def _unproject_rectified(p, uv):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    a = (uv[..., 0] - cx) / fx
    b = (uv[..., 1] - cy) / fy
    return jnp.stack([a, b, jnp.ones_like(a)], axis=-1)


def _unproject_pinhole(p, uv, iters: int = 8):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    a, b = xd, yd
    for _ in range(iters):  # fixed-point undistortion
        r2 = a * a + b * b
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
        dy = p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
        a = (xd - dx) / radial
        b = (yd - dy) / radial
    return jnp.stack([a, b, jnp.ones_like(a)], axis=-1)


def _unproject_kb8(p, uv, iters: int = 10):
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my).clip(1e-12)
    theta = theta_d
    for _ in range(iters):  # Newton on f(θ) = θ·poly(θ²) − θ_d
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / jnp.where(jnp.abs(df) < 1e-8, 1e-8, df)
    scale = jnp.tan(theta) / theta_d
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def unproject(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Unproject pixels (..., 2) to unit-z rays (..., 3)."""
    p = cam.param_array()
    if cam.model == CameraModel.PINHOLE:
        return _unproject_pinhole(p, uv)
    if cam.model == CameraModel.RECTIFIED:
        return _unproject_rectified(p, uv)
    return _unproject_kb8(p, uv)


def project_jacobian_point(cam: Camera, x_cam: jnp.ndarray) -> jnp.ndarray:
    """d(pixel)/d(x_cam): closed form for the hot (tracking/BA) path.

    Returns (..., 2, 3). Uses the undistorted pinhole Jacobian for PINHOLE —
    in the BA inner loop observations are pre-undistorted to normalized
    coordinates (the reference engine does the same: distortion handled at
    extraction time, optimization on undistorted keypoints [upstream]).
    """
    fx, fy = cam.params[0], cam.params[1]
    x, y = x_cam[..., 0], x_cam[..., 1]
    z = jnp.where(jnp.abs(x_cam[..., 2]) < 1e-8, 1e-8, x_cam[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    zeros = jnp.zeros_like(x)
    row0 = jnp.stack([fx * iz, zeros, -fx * x * iz2], axis=-1)
    row1 = jnp.stack([zeros, fy * iz, -fy * y * iz2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def in_image(cam: Camera, uv: jnp.ndarray, margin: float = 0.0) -> jnp.ndarray:
    """Boolean mask: pixel inside the image bounds (with margin)."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )
