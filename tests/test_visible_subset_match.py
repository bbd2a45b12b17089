"""Visible-subset matching (constant-cost search-by-projection for large
maps): equivalence with the dense path when the frustum fits the buffer,
graceful truncation when it does not (SURVEY.md E3 grid-bucketed candidate
generation, as one top_k + gather)."""

import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.frontend import tracking as trk
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops

FX = FY = 300.0
CX, CY = 160.0, 120.0
W, H = 320, 240


def _random_map(rng, n_lm, max_lm):
    cfg = ms.MapConfig(max_kf=4, max_lm=max_lm, n_feat=8)
    m = ms.empty_map(cfg)
    X = np.stack([
        rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
        rng.uniform(3, 9, n_lm),
    ], axis=-1).astype(np.float32)
    bits = rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint32)
    m = m._replace(
        lm_X=m.lm_X.at[:n_lm].set(jnp.asarray(X)),
        lm_bits=m.lm_bits.at[:n_lm].set(jnp.asarray(bits)),
        lm_valid=m.lm_valid.at[:n_lm].set(True),
        n_lm=jnp.asarray(n_lm, jnp.int32),
    )
    return m, X, bits


def _feats_from_landmarks(rng, X, bits, n_feat):
    """Features = projections of a subset of landmarks (identity pose)."""
    sel = rng.choice(len(X), n_feat, replace=False)
    uv = np.stack([
        FX * X[sel, 0] / X[sel, 2] + CX, FY * X[sel, 1] / X[sel, 2] + CY,
    ], axis=-1).astype(np.float32)
    signs = np.asarray(desc_ops.signs_from_bits(jnp.asarray(bits[sel])))
    return sel, jnp.asarray(uv), jnp.asarray(signs)


def test_subset_matches_dense_when_capacity_sufficient():
    rng = np.random.default_rng(0)
    m, X, bits = _random_map(rng, n_lm=500, max_lm=2048)
    sel, uv, signs = _feats_from_landmarks(rng, X, bits, 64)
    mask = jnp.ones((64,), bool)
    args = (m, uv, signs, mask, jnp.eye(3), jnp.zeros(3),
            FX, FY, CX, CY, W, H)
    dense = trk.match_to_map(*args)
    subset = trk.match_to_map(*args, cap_visible=1024)
    np.testing.assert_array_equal(
        np.asarray(dense.obs_lm), np.asarray(subset.obs_lm)
    )
    # every feature whose landmark projects in-frame matches it exactly
    in_frame = (
        (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    )
    in_frame = np.asarray(in_frame)
    obs = np.asarray(subset.obs_lm)
    assert int(subset.n_matches) == in_frame.sum()
    assert np.array_equal(obs[in_frame], sel[in_frame])


def test_subset_truncates_but_still_matches():
    rng = np.random.default_rng(1)
    m, X, bits = _random_map(rng, n_lm=1500, max_lm=2048)
    sel, uv, signs = _feats_from_landmarks(rng, X, bits, 48)
    mask = jnp.ones((48,), bool)
    out = trk.match_to_map(
        m, uv, signs, mask, jnp.eye(3), jnp.zeros(3),
        FX, FY, CX, CY, W, H, cap_visible=1024,
    )
    obs = np.asarray(out.obs_lm)
    # lowest-id-first selection keeps every landmark id < 1024; features
    # whose landmark fell outside the buffer simply don't match
    hit = obs >= 0
    assert hit.sum() >= (sel < 1024).sum() * 0.9
    assert np.array_equal(obs[hit], sel[hit])


def test_gather_visible_prefers_visible_lowest_ids():
    rng = np.random.default_rng(2)
    m, X, bits = _random_map(rng, n_lm=100, max_lm=256)
    # push half the landmarks behind the camera
    X2 = X.copy()
    X2[::2, 2] = -5.0
    m = m._replace(lm_X=jnp.asarray(np.pad(X2, ((0, 156), (0, 0)))))
    lm_uv, lm_vis = trk.project_map(
        m, jnp.eye(3), jnp.zeros(3), FX, FY, CX, CY, W, H
    )
    idx, _, _, sub_valid = trk.gather_visible_landmarks(m, lm_uv, lm_vis, 64)
    idx = np.asarray(idx)
    sub_valid = np.asarray(sub_valid)
    vis_ids = np.flatnonzero(np.asarray(lm_vis))
    n_vis = len(vis_ids)
    assert sub_valid[:n_vis].all()
    assert np.array_equal(np.sort(idx[:n_vis]), vis_ids[:64])
