"""The single-launch pose-LM kernel (backend/pose_opt_fused.py) against
the plain XLA `pose_opt.optimize_pose` it replaces on the GPU.

The Pallas-Triton kernel runs here through the Pallas interpreter; its
compiled form is checked by the `gpu`-marked test on the card. The
implementation chooser and the kernel's padding rules are plain Python
and are checked directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_ros2_tpu.backend import pose_opt, pose_opt_fused
from orb_slam3_ros2_tpu.geom import lie
from orb_slam3_ros2_tpu.ops import chol_small


def _pose_case(seed=1, N=300, outlier_frac=0.3, mask_frac=0.05):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(4, 10, N)], -1).astype(np.float32)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    R_true = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    xc = X @ R_true.T + t_true
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-80, 80, (out.sum(), 2))
    mask = rng.random(N) >= mask_frac
    invs2 = (1.2 ** (-2.0 * rng.integers(0, 8, N))).astype(np.float32)
    return (jnp.eye(3), jnp.zeros(3), jnp.asarray(X), jnp.asarray(uv),
            jnp.asarray(invs2), jnp.asarray(mask), fx, fy, cx, cy,
            R_true, t_true)


def _compare(got, ref, R_true=None, t_true=None):
    if R_true is not None:  # both converge to the true pose
        assert np.abs(np.asarray(got.R) - R_true).max() < 2e-3
        assert np.abs(np.asarray(got.t) - t_true).max() < 1e-2
    # the same algorithm: pose to 1e-4, identical inlier sets
    np.testing.assert_allclose(np.asarray(got.R), np.asarray(ref.R),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.inliers),
                                  np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("N,outlier_frac,mask_frac", [
    (300, 0.3, 0.05),   # not a power of two, a third outliers
    (1000, 0.1, 0.05),  # the EuRoC feature budget (pads to 1024)
    (77, 0.0, 0.0),     # tiny, pads to the minimum block
])
def test_pose_lm_kernel_interpret_matches_reference(N, outlier_frac,
                                                    mask_frac):
    (R0, t0, X, uv, invs2, mask, fx, fy, cx, cy,
     R_true, t_true) = _pose_case(N=N, outlier_frac=outlier_frac,
                                  mask_frac=mask_frac)
    ref = pose_opt.optimize_pose(R0, t0, X, uv, invs2, mask, fx, fy, cx, cy)
    got = pose_opt_fused.pose_lm_kernel(R0, t0, X, uv, invs2, mask,
                                        fx, fy, cx, cy, interpret=True)
    _compare(got, ref, R_true, t_true)


def test_pose_lm_kernel_interpret_all_masked():
    """No valid observation: the pose stays put and nothing is an inlier."""
    (R0, t0, X, uv, invs2, mask, fx, fy, cx, cy, _, _) = _pose_case(N=130)
    mask = jnp.zeros_like(mask)
    ref = pose_opt.optimize_pose(R0, t0, X, uv, invs2, mask, fx, fy, cx, cy)
    got = pose_opt_fused.pose_lm_kernel(R0, t0, X, uv, invs2, mask,
                                        fx, fy, cx, cy, interpret=True)
    _compare(got, ref)
    assert int(got.n_inliers) == 0
    np.testing.assert_allclose(np.asarray(got.R), np.eye(3), atol=1e-6)


@pytest.mark.gpu
def test_pose_lm_kernel_compiled_matches_reference(gpu):
    (R0, t0, X, uv, invs2, mask, fx, fy, cx, cy,
     R_true, t_true) = _pose_case(N=1250)
    got = pose_opt_fused.pose_lm_kernel(R0, t0, X, uv, invs2, mask,
                                        fx, fy, cx, cy)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = pose_opt.optimize_pose(
            *jax.device_put((R0, t0, X, uv, invs2, mask), cpu),
            fx, fy, cx, cy)
    _compare(got, ref, R_true, t_true)


def test_choose_impl_per_platform():
    assert pose_opt_fused.choose_impl("gpu") is pose_opt_fused.pose_lm_kernel
    assert pose_opt_fused.choose_impl("cpu") is pose_opt.optimize_pose


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_choose_impl_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no pose-LM implementation"):
        pose_opt_fused.choose_impl(platform)


def test_optimize_pose_fused_on_cpu_is_the_reference():
    (R0, t0, X, uv, invs2, mask, fx, fy, cx, cy, _, _) = _pose_case(N=64)
    a = pose_opt_fused.optimize_pose_fused(R0, t0, X, uv, invs2, mask,
                                           fx, fy, cx, cy)
    b = pose_opt.optimize_pose(R0, t0, X, uv, invs2, mask, fx, fy, cx, cy)
    np.testing.assert_array_equal(np.asarray(a.R), np.asarray(b.R))
    np.testing.assert_array_equal(np.asarray(a.inliers),
                                  np.asarray(b.inliers))


@pytest.mark.parametrize("n,np_,warps", [
    (1, 128, 4), (77, 128, 4), (128, 128, 4), (129, 256, 4),
    (1000, 1024, 8), (1250, 2048, 16), (2048, 2048, 16)])
def test_kernel_block_and_warps(n, np_, warps):
    assert pose_opt_fused.padded_points(n) == np_
    assert pose_opt_fused.num_warps_for(np_) == warps


def test_inv3x3_spd_matches_linalg():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float64)
    spd = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(3)
    got = np.asarray(chol_small.inv3x3_spd(jnp.asarray(spd)))
    np.testing.assert_allclose(got, np.linalg.inv(spd), rtol=1e-5,
                               atol=1e-7)
