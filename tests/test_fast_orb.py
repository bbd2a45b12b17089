"""FAST detector vs OpenCV oracle; ORB descriptor invariance; extractor shape
contracts. (SURVEY.md §4: per-kernel oracle tests vs OpenCV on CPU.)"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_ros2_tpu.frontend import extractor as ex
from orb_slam3_ros2_tpu.ops import fast as fast_ops
from orb_slam3_ros2_tpu.ops import matcher
from orb_slam3_ros2_tpu.ops import orb_descriptor as desc_ops


def checkerboard_image(h=240, w=320, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(40):
        y, x = rng.integers(20, h - 40), rng.integers(20, w - 40)
        bh, bw = rng.integers(8, 30, size=2)
        img[y : y + bh, x : x + bw] = rng.uniform(50, 255)
    img += rng.normal(0, 2.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def test_fast_matches_opencv_detection():
    img = checkerboard_image()
    u8 = img.astype(np.uint8)
    th = 20
    score = np.asarray(fast_ops.fast_score(jnp.asarray(u8.astype(np.float32))))

    det = cv2.FastFeatureDetector_create(
        threshold=th, nonmaxSuppression=False, type=cv2.FastFeatureDetector_TYPE_9_16
    )
    kps = det.detect(u8)
    cv_mask = np.zeros(img.shape, bool)
    for kp in kps:
        cv_mask[int(round(kp.pt[1])), int(round(kp.pt[0]))] = True

    ours = score > th
    inter = ours[3:-3, 3:-3] & cv_mask[3:-3, 3:-3]
    union_cv = cv_mask[3:-3, 3:-3].sum()
    union_ours = ours[3:-3, 3:-3].sum()
    assert union_cv > 50  # sanity: scene has corners
    # detection agreement (integer-threshold rounding causes slight diffs)
    assert inter.sum() / max(union_cv, 1) > 0.95
    assert inter.sum() / max(union_ours, 1) > 0.95


def test_fast_score_matches_opencv_score_ordering():
    img = checkerboard_image(seed=1)
    u8 = img.astype(np.uint8)
    det = cv2.FastFeatureDetector_create(threshold=12, nonmaxSuppression=True)
    kps = det.detect(u8)
    score = np.asarray(fast_ops.fast_score(jnp.asarray(u8.astype(np.float32))))
    ours = []
    cvs = []
    for kp in kps[:200]:
        x, y = int(round(kp.pt[0])), int(round(kp.pt[1]))
        if 3 <= y < img.shape[0] - 3 and 3 <= x < img.shape[1] - 3:
            ours.append(score[y, x])
            cvs.append(kp.response)
    ours, cvs = np.array(ours), np.array(cvs)
    assert len(ours) > 30
    # same corner-strength definition up to rounding: high rank correlation
    from scipy.stats import spearmanr

    rho, _ = spearmanr(ours, cvs)
    assert rho > 0.95


def test_nms_keeps_local_maxima_only():
    score = jnp.zeros((32, 32)).at[10, 10].set(5.0).at[10, 11].set(4.0).at[20, 20].set(3.0)
    keep = np.asarray(fast_ops.nms3x3(score))
    assert keep[10, 10] and keep[20, 20]
    assert not keep[10, 11]


def test_descriptor_rotation_invariance():
    """Rotating the image should leave descriptors nearly unchanged."""
    img = checkerboard_image(h=256, w=256, seed=2)
    angle_deg = 30.0
    M = cv2.getRotationMatrix2D((128, 128), angle_deg, 1.0)
    rot = cv2.warpAffine(img, M, (256, 256), flags=cv2.INTER_LINEAR)

    cfg = ex.ExtractorConfig(n_features=300, n_levels=4, height=256, width=256)
    extract = ex.make_extractor(cfg)
    fa = extract(jnp.asarray(img))
    fb = extract(jnp.asarray(rot))

    # ground-truth correspondence by warping fa.uv
    uv = np.asarray(fa.uv)
    ones = np.ones((uv.shape[0], 1))
    uv_warp = (np.concatenate([uv, ones], axis=1) @ M.T)[:, :2]

    res = matcher.match(
        fa.signs, fa.mask, fb.signs, fb.mask, max_dist=80.0, ratio=1.0, mutual=True
    )
    idx = np.asarray(res.idx)
    ok = idx >= 0
    uvb = np.asarray(fb.uv)
    correct = 0
    total = 0
    for i in np.where(ok)[0]:
        pred = uv_warp[i]
        if 0 <= pred[0] < 256 and 0 <= pred[1] < 256:
            total += 1
            if np.linalg.norm(uvb[idx[i]] - pred) < 4.0:
                correct += 1
    assert total > 35  # synthetic scene has ~100 corners total
    assert correct / total > 0.7, f"rotation-match precision {correct}/{total}"


def test_extractor_shapes_and_masks():
    cfg = ex.ExtractorConfig(n_features=500, n_levels=8, height=240, width=320)
    extract = ex.make_extractor(cfg)
    img = jnp.asarray(checkerboard_image(240, 320, seed=3))
    f = extract(img)
    n = ex.total_capacity(cfg)
    assert f.uv.shape == (n, 2)
    assert f.signs.shape == (n, 256)
    assert f.bits.shape == (n, 8)
    assert bool(f.mask.sum() > 100)
    uv = np.asarray(f.uv)[np.asarray(f.mask)]
    assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 320).all()
    assert (uv[:, 1] >= 0).all() and (uv[:, 1] < 240).all()


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(4)
    bits = jnp.asarray(rng.integers(0, 2, size=(17, 256)).astype(bool))
    packed = desc_ops.pack_bits(bits)
    unpacked = desc_ops.unpack_bits(packed)
    np.testing.assert_array_equal(np.asarray(unpacked), np.asarray(bits))


def test_hamming_matrix_equals_popcount():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2, size=(13, 256)).astype(bool)
    b = rng.integers(0, 2, size=(9, 256)).astype(bool)
    sa = jnp.where(jnp.asarray(a), 1.0, -1.0)
    sb = jnp.where(jnp.asarray(b), 1.0, -1.0)
    d = np.asarray(matcher.hamming_matrix(sa, sb))
    want = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_allclose(d, want, atol=1e-3)


def test_match_respects_gate_and_mask():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, size=(8, 256)).astype(bool)
    signs = jnp.where(jnp.asarray(bits), 1.0, -1.0)
    mask = jnp.ones((8,), bool)
    gate = jnp.eye(8, dtype=bool)
    res = matcher.match(signs, mask, signs, mask, max_dist=10.0, ratio=1.0,
                        gate=gate, mutual=True)
    np.testing.assert_array_equal(np.asarray(res.idx), np.arange(8))
    # masking out B rows kills matches
    res2 = matcher.match(signs, mask, signs, jnp.zeros((8,), bool))
    assert (np.asarray(res2.idx) == -1).all()
