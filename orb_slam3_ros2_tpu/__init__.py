"""orb_slam3_ros2_tpu — a visual(-inertial) SLAM framework in JAX.

A from-scratch re-design (JAX / XLA / Pallas / shard_map) of the
capabilities of EricPedley/ORB_SLAM3_ROS2 (a ROS 2 wrapper around an ORB-SLAM3 fork): ORB
feature extraction and Hamming matching, monocular / stereo / visual-inertial
tracking, local-mapping bundle adjustment, IMU preintegration with staged
visual-inertial initialization (VIBA 1/2), loop closing with place recognition
and pose-graph optimization, and a multi-map Atlas with save/load — plus the
wrapper's host surface (image + IMU streams in; odometry, trajectory, map
point cloud, occupancy grid, and annotated video out; reference contract:
/root/reference/src/imu_mono_realsense.cpp).

Design stance (see SURVEY.md §7): functional core of fixed-capacity masked
arrays, jitted pure functions for every engine stage, host-side state machine,
sharding over a `jax.sharding.Mesh` for distributed bundle adjustment.
"""

__version__ = "0.1.0"

import jax as _jax

# f32 matmuls run as full f32 everywhere: on the GPU the default precision
# would let XLA use TF32 (about three decimal digits) for them. The
# geometry/BA path (projection Jacobian einsums, Schur contractions, pose
# solves) is accuracy-critical — with reduced-precision matmuls the synthetic
# mono benchmark's ATE degraded ~4.7x (0.030 m -> 0.141 m, measured with
# bf16 passes). This setting does not touch bf16 operands: the ±1 Hamming
# matmul in ops/matcher.py runs on bf16 with f32 accumulation, which is
# exact.
_jax.config.update("jax_default_matmul_precision", "highest")


def __getattr__(name):  # lazy — keeps `import orb_slam3_ros2_tpu.geom` light
    if name in ("System", "Sensor"):
        from orb_slam3_ros2_tpu.runtime import system

        return getattr(system, name)
    raise AttributeError(name)
