"""Native (and fallback) host feeder: QoS drop policies + IMU assembly."""

import numpy as np
import pytest

from orb_slam3_ros2_tpu.runtime.feeder import NativeFeeder, feeder_lib


@pytest.fixture(params=["native", "python"])
def feeder(request):
    if request.param == "native" and feeder_lib() is None:
        pytest.skip("native library not built")
    return NativeFeeder(
        width=32, height=24, frame_cap=3, imu_cap=8,
        force_python=request.param == "python",
    )


def test_frame_resize_and_gray(feeder):
    img = np.zeros((48, 64, 3), np.uint8)
    img[:, :32] = 200
    assert feeder.push_frame(0.1, img)
    t, out, imu = feeder.next()
    assert t == 0.1
    assert out.shape == (24, 32)
    assert out[:, :12].mean() > 150
    assert out[:, 20:].mean() < 50
    assert imu.shape == (0, 7)


def test_imu_assembly_interval(feeder):
    for i in range(6):
        feeder.push_imu(0.01 * i, [0.1 * i, 0, 0], [0, 0, 9.8])
    img = np.zeros((24, 32), np.uint8)
    feeder.push_frame(0.025, img)
    feeder.push_frame(0.055, img)
    t, _, imu1 = feeder.next()
    assert t == 0.025
    # samples at t=0.0, 0.01, 0.02 (t <= frame time)
    assert imu1.shape[0] == 3
    t, _, imu2 = feeder.next()
    # strictly after previous frame: 0.03, 0.04, 0.05
    assert imu2.shape[0] == 3
    assert (imu2[:, 0] > 0.025).all()
    np.testing.assert_allclose(imu2[0, 1], 0.3, atol=1e-9)


def test_frame_queue_lossless_policy(feeder):
    img = np.zeros((24, 32), np.uint8)
    assert feeder.push_frame(0.0, img)
    assert feeder.push_frame(0.1, img)
    assert feeder.push_frame(0.2, img)
    assert not feeder.push_frame(0.3, img)  # full -> rejected, not dropped-old
    assert feeder.pending_frames() == 3
    assert feeder.stats()["dropped_frames"] == 1


def test_imu_drop_oldest_policy(feeder):
    for i in range(12):
        feeder.push_imu(0.01 * i, [0, 0, 0], [0, 0, 9.8])
    s = feeder.stats()
    assert s["dropped_imu"] == 4  # cap 8


def test_imu_nan_rejected(feeder):
    assert not feeder.push_imu(0.0, [np.nan, 0, 0], [0, 0, 9.8])
    assert not feeder.push_imu(0.0, [0, 0, 0], [0, np.nan, 9.8])


def test_next_empty_returns_none(feeder):
    assert feeder.next() is None
