"""Oriented BRIEF-256 descriptors + intensity-centroid orientation (E1 part 3).

Reference behavior: `ORBextractor` computes IC_Angle orientation over a
radius-15 circular patch and a 256-bit steered-BRIEF descriptor from a fixed
learned sampling pattern [upstream; surfaced in the snapshot only through the
descriptor-consuming settings/vocabulary, `/root/reference/src/imu_mono_realsense.cpp:52-53`].

Design decisions:
* The sampling pattern is generated here (seeded Gaussian pairs inside a
  radius-13 disc) rather than copying OpenCV's learned table — descriptors
  only need to be *internally* consistent (matcher + our own vocabulary),
  and a disc-bounded pattern stays inside the gathered patch under rotation.
* Descriptors live in two forms:
  - ``bits`` packed as (N, 8) uint32 for storage/serialization,
  - ``signs`` as (N, 256) ±1 — the compute form. Hamming distance
    becomes ``(256 - signs_a @ signs_b.T) / 2``: one matmul for every pair
    of descriptors (ops/matcher.py).
* Patch gather is a vmapped `dynamic_slice` (keypoints are already clamped
  to the interior by the extractor's border margin).
* Steering is exact per keypoint: 512 bilinear samples at the rotated
  pattern, gathered from the patch (on an H100 this measured faster inside
  the tracking step than an angle-binned steering matmul).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH = 31  # gathered patch edge (±15 around the keypoint)
PATCH_R = PATCH // 2
PATTERN_R = 13.0  # sampling pattern disc radius; rotation-safe inside PATCH
N_BITS = 256
ORI_RADIUS = 15


@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) float32: per bit, two (y, x) offsets inside the disc."""
    rng = np.random.default_rng(1769)  # fixed seed — pattern is part of the format
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(scale=PATTERN_R / 2.0, size=(N_BITS, 2))
        r = np.linalg.norm(cand, axis=-1)
        ok = cand[r <= PATTERN_R - 0.5]
        pts.extend(ok.tolist())
    arr = np.asarray(pts[: N_BITS * 2], dtype=np.float32).reshape(N_BITS, 2, 2)
    return arr


@functools.lru_cache(maxsize=None)
def _orientation_mask() -> np.ndarray:
    """(PATCH, PATCH) disc mask of radius ORI_RADIUS for IC moments."""
    yy, xx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    return ((yy * yy + xx * xx) <= ORI_RADIUS * ORI_RADIUS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _offset_grids():
    yy, xx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    return yy.astype(np.float32), xx.astype(np.float32)


def gather_patches(img: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Gather (N, PATCH, PATCH) patches centered at integer coords yx (N, 2).

    Coordinates must satisfy PATCH_R <= y < H-PATCH_R (ditto x); the extractor
    guarantees this via its edge margin. Invalid (masked) keypoints may carry
    clamped coordinates — their output is garbage but masked downstream.
    A vmapped `dynamic_slice`, which XLA lowers to one native gather.
    """
    start = jnp.asarray(yx, dtype=jnp.int32) - PATCH_R

    def slice_one(s):
        return jax.lax.dynamic_slice(img, (s[0], s[1]), (PATCH, PATCH))

    return jax.vmap(slice_one)(start)


def gather_patches_multi(imgs, yx: jnp.ndarray):
    """Gather the same (N, PATCH, PATCH) windows from several same-shape
    images (e.g. the raw canvas for orientation moments + the blurred
    canvas for BRIEF)."""
    return tuple(gather_patches(im, yx) for im in imgs)


def orientations(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle per patch: (N, P, P) -> (N,) radians.

    Written as one (N, P²) @ (P², 2) matmul over the gathered patches.
    """
    mask = _orientation_mask()
    yy, xx = _offset_grids()
    wts = jnp.asarray(
        np.stack([(mask * yy).ravel(), (mask * xx).ravel()], axis=-1)
    )  # (P*P, 2)
    m = patches.reshape(patches.shape[0], -1) @ wts
    return jnp.arctan2(m[:, 0], m[:, 1])


def _bilinear_sample(patch_flat: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray):
    """Bilinear sample a flattened (P*P,) patch at float coords (per point)."""
    y = jnp.clip(y + PATCH_R, 0.0, PATCH - 1.001)
    x = jnp.clip(x + PATCH_R, 0.0, PATCH - 1.001)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    fy = y - y0
    fx = x - x0
    idx = y0 * PATCH + x0
    v00 = patch_flat[idx]
    v01 = patch_flat[idx + 1]
    v10 = patch_flat[idx + PATCH]
    v11 = patch_flat[idx + PATCH + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def steered_samples(patches: jnp.ndarray, angles: jnp.ndarray):
    """(N, 256, 2) patch intensities at each bit's two pattern points,
    rotated by the keypoint angle (per-keypoint bilinear gathers)."""
    pat = jnp.asarray(brief_pattern())  # (256, 2, 2) — (y, x)
    cos = jnp.cos(angles)
    sin = jnp.sin(angles)
    # rotate by +angle in image coords (y down): y' = s·x + c·y, x' = c·x − s·y
    py = pat[:, :, 0][None]  # (1, 256, 2)
    px = pat[:, :, 1][None]
    ry = sin[:, None, None] * px + cos[:, None, None] * py  # (N, 256, 2)
    rx = cos[:, None, None] * px - sin[:, None, None] * py
    flat = patches.reshape(patches.shape[0], -1)
    vals = jax.vmap(_bilinear_sample)(
        flat, ry.reshape(ry.shape[0], -1), rx.reshape(rx.shape[0], -1)
    )
    return vals.reshape(patches.shape[0], N_BITS, 2)


def describe(patches: jnp.ndarray, angles: jnp.ndarray):
    """Steered BRIEF-256 for each patch.

    patches: (N, PATCH, PATCH) from the *blurred* level image; angles (N,).
    Returns (signs (N, 256) float32 in {-1, +1}, bits (N, 8) uint32).
    """
    vals = steered_samples(patches, angles)
    bits_bool = vals[:, :, 0] < vals[:, :, 1]  # tau test: v_s0 < v_s1
    signs = jnp.where(bits_bool, 1.0, -1.0).astype(jnp.float32)
    bits = pack_bits(bits_bool)
    return signs, bits


def pack_bits(bits_bool: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) bool -> (N, 8) uint32 (little-endian within each word)."""
    b = bits_bool.astype(jnp.uint32).reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) bool."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(packed.shape[0], 256).astype(bool)


def signs_from_bits(packed: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(unpack_bits(packed), 1.0, -1.0).astype(jnp.float32)
