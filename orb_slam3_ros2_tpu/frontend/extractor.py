"""ORB feature extraction pipeline (E1): pyramid → FAST → grid top-k →
orientation → steered BRIEF, all fixed-shape and jit-compiled per config.

Reference parameter surface (`ORBextractor.*` keys in all 24 settings YAMLs,
e.g. `/root/reference/config/Monocular-Inertial/EuRoC.yaml:56-69`):
nFeatures, scaleFactor, nLevels, iniThFAST, minThFAST.

A fixed-shape redesign of the reference's quadtree keypoint distribution
(`DistributeOctTree` [upstream]): each level is divided into fixed
CELL×CELL-pixel cells; per cell the best NMS-surviving corner is selected
with a ranking bonus for clearing the *high* threshold (this reproduces the
iniThFAST→minThFAST fallback without control flow); then a global
`lax.top_k` per level takes the level's feature budget. Output arrays have
static shape (n_features_total, …) with a validity mask.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.ops import fast as fast_ops
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops
from orb_slam3_ros2_tpu.ops import pyramid as pyr_ops

CELL = 32  # spatial-uniformity cell size in pixels
PER_CELL = 5  # candidates kept per cell before the global budget top-k
EDGE = 19  # extraction margin: patch radius 15 + blur/fast slack


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    height: int = 480
    width: int = 752


@dataclasses.dataclass
class Features:
    """Fixed-capacity feature set for one frame. All arrays length N.

    uv: (N, 2) float32 pixel coords at level-0 scale (x, y).
    level: (N,) int32 pyramid level.
    angle: (N,) float32 radians.
    score: (N,) float32 FAST score.
    signs: (N, 256) float32 ±1 descriptor (compute form).
    bits: (N, 8) uint32 packed descriptor (storage form).
    mask: (N,) bool validity.
    """

    uv: jnp.ndarray
    level: jnp.ndarray
    angle: jnp.ndarray
    score: jnp.ndarray
    signs: jnp.ndarray
    bits: jnp.ndarray
    mask: jnp.ndarray


jax.tree_util.register_pytree_node(
    Features,
    lambda f: ((f.uv, f.level, f.angle, f.score, f.signs, f.bits, f.mask), None),
    lambda _, c: Features(*c),
)


PACK_GAP = 8  # zero rows between packed levels (> the 4-px stencil reach)


def pack_layout(shapes):
    """[(H_l, W_l)] -> (layout ((row0, H_l, W_l), ...), total_rows): every
    pyramid level stacked vertically in one canvas of width W_0."""
    layout = []
    off = 0
    for (h, w) in shapes:
        layout.append((off, h, w))
        off += h + PACK_GAP
    return tuple(layout), off - PACK_GAP


def _shifted(a: jnp.ndarray, pad: int, dy: int, dx: int, shape):
    """a[y+dy, x+dx] over `shape`, for `a` zero-padded by `pad` on all
    sides."""
    h, w = shape
    return jax.lax.slice(a, (pad + dy, pad + dx),
                         (pad + dy + h, pad + dx + w))


def frontend_packed(levels):
    """All pyramid levels -> (score, keep, blur, raw) packed canvases and
    the static layout.

    Every level is written into one (ΣH_l + gaps, W_0) canvas, and FAST-9,
    3×3 NMS and the 7×7 blur run once over the whole canvas as shifted
    slices of one operand, which XLA fuses into a few stencil kernels. A
    per-row table built from the static layout masks each level's 3-px
    FAST border, so inside a level the score and keep mask equal
    `fast.fast_score` / `fast.nms3x3` on that level exactly; the blur equals
    `pyramid.gaussian_blur` away from a 3-px margin (zero- vs reflect
    padding), which the extractor's EDGE margin excludes."""
    shapes = tuple((int(l.shape[0]), int(l.shape[1])) for l in levels)
    layout, total = pack_layout(shapes)
    W0 = shapes[0][1]
    raw = jnp.zeros((total, W0), jnp.float32)
    for (r0, _, _), im_l in zip(layout, levels):
        raw = jax.lax.dynamic_update_slice(raw, im_l.astype(jnp.float32),
                                           (r0, 0))

    # static per-row layout: row within its level (-1 in gaps), H_l, W_l
    y_in = np.full((total,), -1, np.int32)
    h_row = np.zeros((total,), np.int32)
    w_row = np.zeros((total,), np.int32)
    for (r0, h, w) in layout:
        y_in[r0:r0 + h] = np.arange(h)
        h_row[r0:r0 + h] = h
        w_row[r0:r0 + h] = w
    xs = jnp.arange(W0, dtype=jnp.int32)[None, :]
    y_in_c = jnp.asarray(y_in)[:, None]
    in_level = (y_in_c >= 0) & (xs < jnp.asarray(w_row)[:, None])
    interior = (
        (y_in_c >= fast_ops.BORDER)
        & (y_in_c < jnp.asarray(h_row)[:, None] - fast_ops.BORDER)
        & (xs >= fast_ops.BORDER)
        & (xs < jnp.asarray(w_row)[:, None] - fast_ops.BORDER)
    )

    # FAST-9: max over the 16 arcs of min (bright) / -max (dark) over 9
    P = 4
    a = jnp.pad(raw, P)
    d = [_shifted(a, P, dy, dx, (total, W0)) - raw
         for dy, dx in fast_ops.CIRCLE_OFFSETS]
    best = None
    for k in range(16):
        arc = [d[(k + j) % 16] for j in range(fast_ops.ARC_LEN)]
        lo, hi = arc[0], arc[0]
        for v in arc[1:]:
            lo = jnp.minimum(lo, v)
            hi = jnp.maximum(hi, v)
        s = jnp.maximum(lo, -hi)
        best = s if best is None else jnp.maximum(best, s)
    score = jnp.where(interior, jnp.maximum(best, 0.0), 0.0)

    # 3×3 NMS with fast.nms3x3's raster-order tie-break; neighbours outside
    # the level read -1 exactly as nms3x3's constant padding does
    sp = jnp.pad(jnp.where(in_level, score, -1.0), 1, constant_values=-1.0)
    keep = in_level
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = _shifted(sp, 1, dy, dx, (total, W0))
            if (dy, dx) < (0, 0) or (dy, dx) == (0, -1):
                keep = keep & (score > neigh)
            else:
                keep = keep & (score >= neigh)

    # separable 7×7 Gaussian, vertical then horizontal (pyramid's order)
    taps = [float(v) for v in pyr_ops._gauss_kernel1d(7, 2.0)]
    v = sum(taps[i] * _shifted(a, P, i - 3, 0, (total, W0))
            for i in range(7))
    vp = jnp.pad(v, ((0, 0), (P, P)))
    blur = sum(taps[i] * jax.lax.slice(vp, (0, P + i - 3),
                                       (total, P + i - 3 + W0))
               for i in range(7))
    return score, keep, blur, raw, layout


def _level_grid_select(score: jnp.ndarray, keep: jnp.ndarray, ini_th: float,
                       min_th: float, budget: int) -> Tuple[jnp.ndarray, ...]:
    """Select up to `budget` keypoints on one level.

    Returns (yx (budget, 2) int32, score (budget,), valid (budget,)).
    """
    h, w = score.shape
    # candidates: NMS survivors above the *low* threshold
    cand = keep & (score > min_th)
    # ranking score: low-threshold corners rank below every high-threshold one
    BONUS = 1e4
    rank = jnp.where(cand, score + jnp.where(score > ini_th, BONUS, 0.0), -1.0)

    # mask extraction margin so patches stay in-bounds
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= EDGE) & (ys < h - EDGE) & (xs >= EDGE) & (xs < w - EDGE)
    rank = jnp.where(interior, rank, -1.0)

    # per-cell top-PER_CELL (the quadtree-distribution equivalent), then a
    # global top-`budget` over all cell survivors
    ph = -(-h // CELL) * CELL
    pw = -(-w // CELL) * CELL
    rp = jnp.pad(rank, ((0, ph - h), (0, pw - w)), constant_values=-1.0)
    cells = rp.reshape(ph // CELL, CELL, pw // CELL, CELL).transpose(0, 2, 1, 3)
    cells = cells.reshape(-1, CELL * CELL)  # (n_cells, CELL*CELL)
    # per-cell top-PER_CELL as PER_CELL rounds of (argmax, suppress): a few
    # vector passes instead of lax.top_k's sort-based lowering
    col = jnp.arange(cells.shape[1])[None, :]
    ranks, idxs = [], []
    for _ in range(PER_CELL):
        i = jnp.argmax(cells, axis=1)
        ranks.append(jnp.max(cells, axis=1))
        idxs.append(i)
        cells = jnp.where(col == i[:, None], -1.0, cells)
    cell_rank = jnp.stack(ranks, axis=1)  # (n_cells, PER_CELL)
    cell_idx = jnp.stack(idxs, axis=1)

    n_cells_y = ph // CELL
    n_cells_x = pw // CELL
    cell_ids = jnp.arange(n_cells_y * n_cells_x)
    cy = (cell_ids // n_cells_x)[:, None]
    cx = (cell_ids % n_cells_x)[:, None]
    py = (cy * CELL + cell_idx // CELL).reshape(-1)
    px = (cx * CELL + cell_idx % CELL).reshape(-1)
    flat_rank = cell_rank.reshape(-1)

    k = min(budget, flat_rank.shape[0])
    top_rank, top_idx = jax.lax.top_k(flat_rank, k)
    yx = jnp.stack([py[top_idx], px[top_idx]], axis=-1).astype(jnp.int32)
    valid = top_rank > 0.0
    raw_score = jnp.where(top_rank > BONUS / 2, top_rank - BONUS, top_rank)

    # sub-pixel refinement: 1-D parabola fit on the score along each axis
    # (integer keypoints quantize reprojection residuals by ~0.5 px/level,
    # which dominates pose error at short focal lengths)
    ys = jnp.clip(yx[:, 0], 1, h - 2)
    xs_ = jnp.clip(yx[:, 1], 1, w - 2)
    s0 = score[ys, xs_]
    sym = score[ys - 1, xs_]
    syp = score[ys + 1, xs_]
    sxm = score[ys, xs_ - 1]
    sxp = score[ys, xs_ + 1]
    # denominator is negative at a local maximum — clamp from above
    dy = 0.5 * (sym - syp) / jnp.minimum(sym - 2 * s0 + syp, -1e-6)
    dx = 0.5 * (sxm - sxp) / jnp.minimum(sxm - 2 * s0 + sxp, -1e-6)
    offset = jnp.stack(
        [jnp.clip(dy, -0.5, 0.5), jnp.clip(dx, -0.5, 0.5)], axis=-1
    )
    # pad to exactly `budget`
    if k < budget:
        pad = budget - k
        yx = jnp.pad(yx, ((0, pad), (0, 0)))
        raw_score = jnp.pad(raw_score, (0, pad))
        valid = jnp.pad(valid, (0, pad))
        offset = jnp.pad(offset, ((0, pad), (0, 0)))
    return yx, raw_score, valid, offset


@functools.lru_cache(maxsize=8)
def make_extractor(cfg: ExtractorConfig):
    """Build the jitted extraction function for a static config.

    Returns extract(img: (H, W) float32) -> Features with
    N = sum of per-level budgets (== cfg.n_features padded by rounding).
    """
    budgets = pyr_ops.features_per_level(cfg.n_features, cfg.n_levels,
                                         cfg.scale_factor)
    scales = pyr_ops.scale_factors(cfg.n_levels, cfg.scale_factor)

    def extract(img: jnp.ndarray) -> Features:
        with jax.named_scope("pyramid"):
            levels = pyr_ops.build_pyramid(img, cfg.n_levels,
                                           cfg.scale_factor)
        # packed-pyramid frontend: every level's FAST+NMS+blur as one
        # stencil pass over one stacked canvas, and the aligned raw/blur
        # canvases let the patch gather below run once over ALL levels'
        # keypoints
        with jax.named_scope("frontend"):
            score_c, keep_c, blur_c, raw_c, layout = frontend_packed(levels)
        uv_all, lvl_all, sc_all, yx_all, mask_all = [], [], [], [], []
        for lvl, ((r0, h, w), budget) in enumerate(zip(layout, budgets)):
            if budget <= 0:
                continue
            score = jax.lax.slice(score_c, (r0, 0), (r0 + h, w))
            keep = jax.lax.slice(keep_c, (r0, 0), (r0 + h, w))
            with jax.named_scope("select"):
                yx, sc, valid, subpix = _level_grid_select(
                    score, keep, cfg.ini_th_fast, cfg.min_th_fast, budget
                )
            # clamp coords (invalid entries may sit at the border)
            yx = jnp.clip(yx, EDGE, jnp.asarray([h - EDGE - 1, w - EDGE - 1]))
            s = scales[lvl]
            uv = jnp.stack(
                [(yx[:, 1].astype(jnp.float32) + subpix[:, 1]) * s,
                 (yx[:, 0].astype(jnp.float32) + subpix[:, 0]) * s],
                axis=-1,
            )
            uv_all.append(uv)
            lvl_all.append(jnp.full((budget,), lvl, dtype=jnp.int32))
            sc_all.append(sc)
            yx_all.append(yx + jnp.asarray([r0, 0], jnp.int32))
            mask_all.append(valid)

        # one gather + one orientation + one describe call over all levels:
        # raw patches give IC orientation, blurred patches feed BRIEF
        with jax.named_scope("describe"):
            yx_packed = jnp.concatenate(yx_all, axis=0)
            patches_raw, patches_desc = desc_ops.gather_patches_multi(
                (raw_c, blur_c), yx_packed
            )
            angle = desc_ops.orientations(patches_raw)
            signs, bits = desc_ops.describe(patches_desc, angle)

        return Features(
            uv=jnp.concatenate(uv_all, axis=0),
            level=jnp.concatenate(lvl_all, axis=0),
            angle=angle,
            score=jnp.concatenate(sc_all, axis=0),
            signs=signs,
            bits=bits,
            mask=jnp.concatenate(mask_all, axis=0),
        )

    return jax.jit(extract)


def total_capacity(cfg: ExtractorConfig) -> int:
    return sum(pyr_ops.features_per_level(cfg.n_features, cfg.n_levels,
                                          cfg.scale_factor))
