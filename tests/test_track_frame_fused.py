"""The fused per-frame pipeline (frontend/tracking.track_frame) must be
semantically identical to the four staged calls it replaced (match ->
widened retry -> pose LM -> tight re-match -> second pose LM -> accept the
better stage). The fusion exists to cut host<->device turnarounds (one
packed fetch per frame); it must not change tracking results.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.frontend import extractor as ex
from orb_slam3_ros2_tpu.frontend import tracking as trk
from orb_slam3_ros2_tpu.io.synthetic import _texture

H, W = 240, 320
FX = FY = 260.0
CX, CY = W / 2.0, H / 2.0
MIN_MATCHES = 15
MIN_STAGE1 = 10  # low bar to enter track-local-map (upstream ~10 inliers)


@pytest.fixture(scope="module")
def setup():
    cfg = ex.ExtractorConfig(n_features=512, n_levels=4, height=H, width=W)
    extract = ex.make_extractor(cfg)
    rng = np.random.default_rng(3)
    img = jnp.asarray(_texture(H, W, seed=5).astype(np.float32))
    feats = extract(img)
    uv0 = np.asarray(feats.uv)
    bits0 = np.asarray(feats.bits)
    valid = np.asarray(feats.mask)
    z = rng.uniform(3.0, 8.0, uv0.shape[0]).astype(np.float32)
    X = np.stack([(uv0[:, 0] - CX) / FX * z, (uv0[:, 1] - CY) / FY * z, z],
                 axis=-1).astype(np.float32)
    mcfg = ms.MapConfig(max_kf=8, max_lm=1024, n_feat=ex.total_capacity(cfg))
    L = min(int(valid.sum()), mcfg.max_lm)
    idx = np.flatnonzero(valid)[:L]
    m = ms.empty_map(mcfg)
    m = m._replace(
        lm_X=m.lm_X.at[:L].set(jnp.asarray(X[idx])),
        lm_valid=m.lm_valid.at[:L].set(True),
        lm_bits=m.lm_bits.at[:L].set(jnp.asarray(bits0[idx])),
    )
    return m, feats


def staged(m, feats, R0, t0):
    """The pre-fusion host sequence, verbatim."""
    kw = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    tm = trk.match_to_map(m, feats.uv, feats.signs, feats.mask, R0, t0, **kw)
    if int(tm.n_matches) < MIN_MATCHES:
        tm = trk.match_to_map(m, feats.uv, feats.signs, feats.mask, R0, t0,
                              radius=30.0, **kw)
    res, obs_clean = trk.track_pose(m, tm.obs_lm, feats.uv, feats.level,
                                    R0, t0, FX, FY, CX, CY)
    n_inl = int(res.n_inliers)
    if n_inl < MIN_STAGE1:
        # stage-1 below the LOW bar: a garbage pose — surface as-is (the
        # host declares LOST) without running track-local-map (upstream
        # two-threshold Tracking semantics)
        return tm, res, obs_clean
    tm2 = trk.match_to_map(m, feats.uv, feats.signs, feats.mask,
                           res.R, res.t, radius=7.0, **kw)
    if int(tm2.n_matches) >= n_inl:
        res2, obs2 = trk.track_pose(m, tm2.obs_lm, feats.uv, feats.level,
                                    res.R, res.t, FX, FY, CX, CY)
        if int(res2.n_inliers) >= n_inl:
            res, obs_clean, tm = res2, obs2, tm2
    return tm, res, obs_clean


@pytest.mark.parametrize("perturb", [0.0, 0.02])
def test_fused_matches_staged(setup, perturb):
    m, feats = setup
    rng = np.random.default_rng(11)
    R0 = jnp.eye(3)
    t0 = jnp.asarray(rng.normal(0, perturb, 3).astype(np.float32))
    tm_s, res_s, obs_s = staged(m, feats, R0, t0)
    tm_f, res_f, obs_f, summary = trk.track_frame(
        m, feats.uv, feats.signs, feats.mask, feats.level, R0, t0,
        FX, FY, CX, CY, W, H, min_matches=MIN_MATCHES,
    )
    s = np.asarray(summary)
    assert s.shape == (16,)
    np.testing.assert_allclose(np.asarray(res_f.R), np.asarray(res_s.R),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(res_f.t), np.asarray(res_s.t),
                               atol=1e-5)
    assert int(res_f.n_inliers) == int(res_s.n_inliers)
    assert int(tm_f.n_matches) == int(tm_s.n_matches)
    np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(obs_s))
    # the packed summary mirrors the pytree outputs
    np.testing.assert_allclose(s[:9].reshape(3, 3), np.asarray(res_f.R),
                               atol=1e-6)
    assert int(s[12]) == int(tm_f.n_matches)
    assert int(s[13]) == int(res_f.n_inliers)
    assert int(s[14]) == int(m.n_kf)


def test_lost_boundary_stage1_threshold(setup):
    """When stage-1 pose opt falls below the low
    stage-1 bar, the fused path must surface the stage-1 result unchanged
    (so the host declares LOST and relocalizes), never a stage-2 'rescue'
    re-matched at the garbage pose."""
    m, feats = setup
    R0 = jnp.eye(3)
    t0 = jnp.zeros(3)
    kw = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    # a stage-1 bar no frame can meet: the rescue gate always rejects, so
    # the fused result must be the raw stage-1 (wide retry also forced via
    # min_matches so the reference path is deterministic)
    big = 10 ** 6
    tm_w = trk.match_to_map(m, feats.uv, feats.signs, feats.mask, R0, t0,
                            radius=30.0, **kw)
    res1, obs1 = trk.track_pose(m, tm_w.obs_lm, feats.uv, feats.level,
                                R0, t0, FX, FY, CX, CY)
    tm_f, res_f, obs_f, s = trk.track_frame(
        m, feats.uv, feats.signs, feats.mask, feats.level, R0, t0,
        FX, FY, CX, CY, W, H, min_matches=big, min_stage1=big,
    )
    # stage 2 would typically match at least as many inliers here — it must
    # NOT be accepted because stage 1 is below threshold
    assert int(res_f.n_inliers) == int(res1.n_inliers)
    assert int(s[13]) == int(res1.n_inliers)
    np.testing.assert_allclose(np.asarray(res_f.R), np.asarray(res1.R),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_f.t), np.asarray(res1.t),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(obs_f), np.asarray(obs1))


def test_widen_retry_fires_when_narrow_fails(setup):
    """With a grossly wrong pose prediction the narrow window finds too few
    matches; the fused cond must fall back to the wide window exactly like
    the staged retry."""
    m, feats = setup
    R0 = jnp.eye(3)
    t0 = jnp.asarray(np.array([0.35, 0.0, 0.0], np.float32))
    kw = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    tm_narrow = trk.match_to_map(m, feats.uv, feats.signs, feats.mask,
                                 R0, t0, **kw)
    tm_s, res_s, _ = staged(m, feats, R0, t0)
    tm_f, res_f, _, s = trk.track_frame(
        m, feats.uv, feats.signs, feats.mask, feats.level, R0, t0,
        FX, FY, CX, CY, W, H, min_matches=MIN_MATCHES,
    )
    assert int(tm_f.n_matches) == int(tm_s.n_matches)
    assert int(res_f.n_inliers) == int(res_s.n_inliers)
    if int(tm_narrow.n_matches) < MIN_MATCHES:
        # the retry genuinely fired and found more
        assert int(tm_f.n_matches) >= int(tm_narrow.n_matches)
