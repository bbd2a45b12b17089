"""Stereo matching (E2/E4 stereo path): rectified scanline search → depth.

Reference surface: `Camera.type: "Rectified"` with baseline ``Stereo.b``
(`/root/reference/config/Stereo/RealSense_D435i.yaml:8-16`), KITTI stereo
configs, and depth gating ``Stereo.ThDepth`` (all stereo YAMLs). Upstream
matches left↔right ORB features along epipolar scanlines with sub-pixel
refinement, giving each left keypoint a metric depth z = fx·b/d used to
spawn landmarks from a single keyframe [upstream `Frame::ComputeStereoMatches`].

Design: the scanline constraint is a row-band gate on the dense Hamming
matrix (one matmul for all pairs), disparity comes from the matched
column difference, and sub-pixel refinement is a parabola fit on descriptor
distances of neighboring candidates — all fixed-shape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from orb_slam3_ros2_tpu.ops import matcher


class StereoMatch(NamedTuple):
    depth: jnp.ndarray  # (N,) metric depth for left features (0 = invalid)
    disparity: jnp.ndarray  # (N,)
    right_u: jnp.ndarray  # (N,) matched right-image column
    valid: jnp.ndarray  # (N,)


def match_stereo(
    uv_l: jnp.ndarray,  # (N, 2) left features (rectified pixel coords)
    signs_l: jnp.ndarray,
    mask_l: jnp.ndarray,
    lvl_l: jnp.ndarray,
    uv_r: jnp.ndarray,  # (M, 2) right features
    signs_r: jnp.ndarray,
    mask_r: jnp.ndarray,
    lvl_r: jnp.ndarray,
    fx: float,
    baseline: float,
    max_dist: float = 60.0,
    row_tol: float = 2.0,
    min_disp: float = 0.5,
    max_depth: float = 60.0,
) -> StereoMatch:
    """Row-banded descriptor matching; returns metric depth per left feature."""
    # gates: same scanline (scaled tolerance by pyramid level), positive
    # disparity, disparity within [fx·b/max_depth, ~inf)
    row_gap = jnp.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    tol = row_tol * (1.25 ** jnp.maximum(lvl_l[:, None], lvl_r[None, :]))
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    min_d = fx * baseline / max_depth
    gate = (
        (row_gap <= tol)
        & (disp >= jnp.maximum(min_disp, min_d))
        & (disp <= fx * baseline / 0.3)  # min depth 0.3 m
        & (jnp.abs(lvl_l[:, None] - lvl_r[None, :]) <= 1)
    )
    res = matcher.match(
        signs_l, mask_l, signs_r, mask_r,
        max_dist=max_dist, ratio=0.9, gate=gate, mutual=True,
    )
    idx = jnp.where(res.valid, res.idx, 0)
    ur = uv_r[idx, 0]
    d = uv_l[:, 0] - ur
    valid = res.valid & (d > min_disp)
    depth = jnp.where(valid, fx * baseline / jnp.maximum(d, 1e-6), 0.0)
    return StereoMatch(
        depth=depth, disparity=jnp.where(valid, d, 0.0), right_u=ur,
        valid=valid,
    )


def backproject(uv: jnp.ndarray, depth: jnp.ndarray, fx, fy, cx, cy):
    """Left-camera-frame 3-D points from rectified pixels + depth."""
    x = (uv[:, 0] - cx) / fx * depth
    y = (uv[:, 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], axis=-1)


class StereoObs(NamedTuple):
    """Unified stereo observation: per-left-feature 3-D point in the left
    camera frame. Produced by either stereo path (rectified scanline or
    general two-view) and consumed by landmark spawning."""

    X_cam: jnp.ndarray  # (N, 3) left-camera-frame points (0 where invalid)
    depth: jnp.ndarray  # (N,) z in the left camera (Stereo.ThDepth gating)
    valid: jnp.ndarray  # (N,)


def obs_from_rectified(sm: StereoMatch, uv_l: jnp.ndarray,
                       fx, fy, cx, cy) -> StereoObs:
    X = backproject(uv_l, sm.depth, fx, fy, cx, cy)
    return StereoObs(X_cam=X, depth=sm.depth, valid=sm.valid)


def obs_from_depth(
    uv_raw: jnp.ndarray,  # (N, 2) keypoints in the RAW image (depth frame)
    uv_undist: jnp.ndarray,  # (N, 2) undistorted pixels (projection frame)
    mask: jnp.ndarray,
    depth_img: jnp.ndarray,  # (H, W) metric depth registered to the image
    fx, fy, cx, cy,
    min_depth: float = 0.05,
    max_depth: float = 40.0,
) -> StereoObs:
    """RGBD observations: depth sampled at the detected (raw) keypoint
    location — nearest pixel, matching the upstream RGBD frame constructor
    (bilinear across depth discontinuities would invent phantom points) —
    backprojected through the undistorted pinhole (upstream also optimizes
    on undistorted keypoints with raw-sampled depth)."""
    H, W = depth_img.shape
    u = jnp.clip(jnp.round(uv_raw[:, 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(uv_raw[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_img[v, u]
    valid = mask & jnp.isfinite(d) & (d > min_depth) & (d < max_depth)
    d = jnp.where(valid, d, 0.0)
    X = backproject(uv_undist, d, fx, fy, cx, cy)
    return StereoObs(X_cam=jnp.where(valid[:, None], X, 0.0), depth=d,
                     valid=valid)


def match_stereo_general(
    rays_l: jnp.ndarray,  # (N, 3) unit-z rays in the left camera
    signs_l: jnp.ndarray,
    mask_l: jnp.ndarray,
    lvl_l: jnp.ndarray,
    rays_r: jnp.ndarray,  # (M, 3) unit-z rays in the right camera
    signs_r: jnp.ndarray,
    mask_r: jnp.ndarray,
    lvl_r: jnp.ndarray,
    R12: jnp.ndarray,  # (3, 3) x_c1 = R12 @ x_c2 + t12 (Stereo.T_c1_c2)
    t12: jnp.ndarray,  # (3,)
    max_dist: float = 60.0,
    eps_epi: float = 6e-3,
    min_depth: float = 0.3,
    max_depth: float = 60.0,
    scale_factor: float = 1.2,
) -> StereoObs:
    """Non-rectified stereo: epipolar-gated descriptor matching on rays +
    midpoint triangulation under the general extrinsics ``Stereo.T_c1_c2``.

    This is the path the reference uses for KannalaBrandt8 fisheye stereo
    (TUM-VI: `config/Stereo/TUM-VI.yaml:8,34-41` sets `Camera.type:
    "KannalaBrandt8"` + `Stereo.T_c1_c2`; upstream matches across the
    lapping area and triangulates with both camera models rather than
    rectifying [upstream `KannalaBrandt8::TriangulateMatches`]).

    Design: all pair tests are masks on the dense (N, M) Hamming matrix
    (one matmul); the epipolar test is an angular point-to-plane
    distance on unit rays, so no per-pair linear solves are needed until the
    final per-feature triangulation (closed-form 2x2).
    """
    nl = rays_l / jnp.linalg.norm(rays_l, axis=-1, keepdims=True)
    b = rays_r @ R12.T
    nb = b / jnp.linalg.norm(b, axis=-1, keepdims=True)

    # epipolar plane of each right ray: normal = t12 x b (both in c1)
    n = jnp.cross(jnp.broadcast_to(t12, nb.shape), nb)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    # angular distance of the left ray from that plane, coarser at higher
    # pyramid levels (matches the level-scaled chi2 of the reference)
    epi = jnp.abs(nl @ n.T)  # (N, M)
    tol = eps_epi * (scale_factor ** jnp.maximum(
        lvl_l[:, None], lvl_r[None, :]
    ).astype(jnp.float32))

    # parallax gate: triangulation angle must exceed the angle subtended by
    # the baseline at max_depth (the rectified path's min-disparity test)
    cos_par = nl @ nb.T
    theta_min = jnp.linalg.norm(t12) / max_depth
    gate = (
        (epi <= tol)
        & (cos_par <= jnp.cos(theta_min))
        & (jnp.abs(lvl_l[:, None] - lvl_r[None, :]) <= 1)
    )
    res = matcher.match(
        signs_l, mask_l, signs_r, mask_r,
        max_dist=max_dist, ratio=0.9, gate=gate, mutual=True,
    )
    idx = jnp.where(res.valid, res.idx, 0)
    bm = nb[idx]  # (N, 3) matched right ray in c1
    # midpoint triangulation: x = d1*nl on the left ray, x = t12 + d2*bm on
    # the right ray; least-squares d1, d2 from the 2x2 normal equations
    c = jnp.sum(nl * bm, axis=-1)
    r1t = nl @ t12
    bt = bm @ t12
    den = jnp.maximum(1.0 - c * c, 1e-12)
    d2 = (c * r1t - bt) / den
    d1 = r1t + c * d2
    X = d1[:, None] * nl
    depth = X[:, 2]
    valid = (
        res.valid
        & (d1 > 0) & (d2 > 0)
        & (depth > min_depth) & (depth < max_depth)
    )
    return StereoObs(
        X_cam=jnp.where(valid[:, None], X, 0.0),
        depth=jnp.where(valid, depth, 0.0),
        valid=valid,
    )
