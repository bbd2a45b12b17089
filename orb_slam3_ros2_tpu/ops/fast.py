"""FAST-9/16 corner detection, vectorized over the whole image (E1 part 2).

Reference behavior: `ORBextractor` runs FAST segment-test detection per
pyramid level with a high threshold `iniThFAST` and falls back to
`minThFAST` in empty cells (settings keys in every YAML,
`/root/reference/config/Monocular-Inertial/EuRoC.yaml:64-69`: 20 / 7).

Design: no per-pixel branching — the *exact corner score* (the
maximum threshold at which the segment test still passes, OpenCV's
definition) is computed for every pixel at once as a max-over-16-windows of
min-over-9-offsets of center differences. The dual-threshold fallback then
becomes a pure ranking trick downstream (score > minTh admits a candidate;
score > iniTh outranks all fallback candidates — see extractor.py), with no
data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3, 16 offsets (dy, dx), clockwise from 12 o'clock.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9 (the variant OpenCV's default FAST uses)
BORDER = 3


def _ring(img: jnp.ndarray) -> jnp.ndarray:
    """Stack the 16 circle-shifted images: out[i, y, x] = img[y+dy_i, x+dx_i].

    Uses wrap-around rolls; callers must mask a BORDER-pixel frame.
    """
    return jnp.stack(
        [jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)) for dy, dx in CIRCLE_OFFSETS],
        axis=0,
    )


def fast_score(img: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score (max threshold passing the segment test).

    img: (H, W) float32. Returns (H, W) float32 score; score > t means the
    pixel is a FAST-9 corner at threshold t. Border pixels are forced to 0.
    """
    ring = _ring(img)
    d_bright = ring - img[None]  # >t on all 9 of a window => bright corner
    d_dark = -d_bright  # img - ring

    def windowed_max_min(d):
        # circular sliding window min of length ARC_LEN, then max over windows
        dpad = jnp.concatenate([d, d[: ARC_LEN - 1]], axis=0)  # (24, H, W)
        best = jnp.full(img.shape, -jnp.inf, dtype=img.dtype)
        for k in range(16):
            wmin = jnp.min(dpad[k : k + ARC_LEN], axis=0)
            best = jnp.maximum(best, wmin)
        return best

    score = jnp.maximum(windowed_max_min(d_bright), windowed_max_min(d_dark))
    score = jnp.maximum(score, 0.0)
    # zero the wrap-contaminated border
    h, w = img.shape
    mask = jnp.zeros((h, w), dtype=bool).at[BORDER:h - BORDER, BORDER:w - BORDER].set(True)
    return jnp.where(mask, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression: keep strict local maxima (ties broken by
    raster order via epsilon on the lexicographically-earlier neighbors)."""
    h, w = score.shape
    pad = jnp.pad(score, 1, mode="constant", constant_values=-1.0)
    keep = jnp.ones_like(score, dtype=bool)
    idx = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                idx += 1
                continue
            neigh = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            if (dy, dx) < (0, 0) or ((dy, dx) == (0, -1)):
                keep &= score > neigh  # strictly greater than earlier pixels
            else:
                keep &= score >= neigh
            idx += 1
    return keep
