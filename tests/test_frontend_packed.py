"""The packed-canvas frontend (FAST-9 + 3×3 NMS + 7×7 blur over every
pyramid level at once) against the per-level oracles in ops/fast.py and
ops/pyramid.py, at the image shapes the settings tree uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_ros2_tpu.frontend import extractor as ex
from orb_slam3_ros2_tpu.io import synthetic
from orb_slam3_ros2_tpu.ops import fast as fast_ops
from orb_slam3_ros2_tpu.ops import pyramid as pyr_ops


def _image(h, w, seed):
    return jnp.asarray(synthetic._texture(h, w, seed=seed)
                       .astype(np.float32))


def _per_level_canvases(levels):
    """The per-level composition written into the packed layout: what
    frontend_packed must equal inside every level."""
    shapes = [tuple(l.shape) for l in levels]
    layout, total = ex.pack_layout(shapes)
    W0 = shapes[0][1]
    out = [jnp.zeros((total, W0), jnp.float32), jnp.zeros((total, W0), bool),
           jnp.zeros((total, W0), jnp.float32),
           jnp.zeros((total, W0), jnp.float32)]
    for (r0, _, _), im in zip(layout, levels):
        s = fast_ops.fast_score(im)
        parts = (s, fast_ops.nms3x3(s), pyr_ops.gaussian_blur(im), im)
        out = [jax.lax.dynamic_update_slice(c, p, (r0, 0))
               for c, p in zip(out, parts)]
    return (*out, layout)


@pytest.mark.parametrize("shape", [(480, 752), (480, 640), (376, 1241)],
                         ids=["euroc", "d435i", "kitti"])
def test_frontend_packed_matches_per_level_oracles(shape):
    h, w = shape
    levels = pyr_ops.build_pyramid(_image(h, w, seed=3), 8, 1.2)
    score, keep, blur, raw, layout = (
        np.asarray(v) if i < 4 else v
        for i, v in enumerate(jax.jit(ex.frontend_packed)(levels)))
    assert len(layout) == 8 and layout[0] == (0, h, w)
    for (r0, lh, lw), im in zip(layout, levels):
        s_ref = np.asarray(fast_ops.fast_score(im))
        k_ref = np.asarray(fast_ops.nms3x3(fast_ops.fast_score(im)))
        b_ref = np.asarray(pyr_ops.gaussian_blur(im))
        # FAST scores and keep masks are exact: integer differences of the
        # same pixels, min/max only
        np.testing.assert_array_equal(score[r0:r0 + lh, :lw], s_ref)
        np.testing.assert_array_equal(keep[r0:r0 + lh, :lw], k_ref)
        # blur: zero- vs reflect-padding differs only within 3 px
        np.testing.assert_allclose(blur[r0 + 3:r0 + lh - 3, 3:lw - 3],
                                   b_ref[3:-3, 3:-3], atol=1e-3)
        np.testing.assert_array_equal(raw[r0:r0 + lh, :lw], np.asarray(im))
        assert not score[r0:r0 + lh, lw:].any()  # right of a narrow level
    for (r0, lh, _) in layout[:-1]:  # gap rows carry no corners
        assert not score[r0 + lh:r0 + lh + ex.PACK_GAP].any()
        assert not keep[r0 + lh:r0 + lh + ex.PACK_GAP].any()


def test_pack_layout_rows():
    layout, total = ex.pack_layout([(10, 20), (8, 16), (6, 12)])
    assert layout == ((0, 10, 20), (18, 8, 16), (34, 6, 12))
    assert total == 40


def test_extractor_packed_path_equals_per_level_path(monkeypatch):
    """The whole extractor on the packed stencil equals the same extractor
    fed the per-level oracle canvases."""
    cfg = ex.ExtractorConfig(n_features=300, n_levels=4, height=120,
                             width=200)
    img = _image(120, 200, seed=5)
    ex.make_extractor.cache_clear()
    got = ex.make_extractor(cfg)(img)
    ex.make_extractor.cache_clear()
    monkeypatch.setattr(ex, "frontend_packed", _per_level_canvases)
    want = ex.make_extractor(cfg)(img)
    ex.make_extractor.cache_clear()
    assert int(np.asarray(want.mask).sum()) > 100
    for f in ("uv", "level", "score", "mask", "angle"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    # descriptor bits may flip only where a tau difference is ~0 (blur
    # summation order)
    flips = np.mean(np.asarray(got.signs) != np.asarray(want.signs))
    assert flips <= 0.01, flips
