"""Device-mesh helpers for the distributed engine (SURVEY.md §2.4).

The reference has no scale-out at all (ROS DDS pub/sub only,
`/root/reference/package.xml:11-24`); this build introduces SLAM-specific
data parallelism: landmark-sharded bundle adjustment and pose-graph blocks
over ICI collectives. These helpers build the `jax.sharding.Mesh` used by
parallel/sharded_ba.py and the multi-chip dry-run entry point.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


LM_AXIS = "lm"  # landmark-sharding axis (BA Schur reduction rides psum here)
KF_AXIS = "kf"  # keyframe-sharding axis (pose-graph / map-block ops)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (LM_AXIS,),
    devices=None,
) -> Mesh:
    """1-D (default) or n-D mesh over the available devices."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        # split n into a near-square factorization for 2-D meshes
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (a, n // a)
    return Mesh(np.asarray(devs).reshape(shape), axis_names)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_devices: int = 0) -> None:
    """Join a multi-process JAX runtime, one process per group of devices.

    With `JAX_PLATFORMS=cpu` each process gets `local_devices` virtual CPU
    devices (the test setup). Otherwise each process owns its own
    accelerators: `local_devices` per process (default 1), process p taking
    local ids [p·n, (p+1)·n), so processes on one host never open — or
    reserve memory on — each other's cards."""
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        if local_devices:
            # drop an inherited device-count flag before forcing this
            # process's count
            kept = [f for f in os.environ.get("XLA_FLAGS", "").split()
                    if "xla_force_host_platform_device_count" not in f]
            kept.append("--xla_force_host_platform_device_count="
                        f"{local_devices}")
            os.environ["XLA_FLAGS"] = " ".join(kept)
        jax.config.update("jax_platforms", "cpu")
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return
    n = local_devices or 1
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=list(range(process_id * n, (process_id + 1) * n)),
    )


def pad_to_multiple(x, axis: int, multiple: int, fill=0):
    """Pad `axis` of array x up to a multiple (sharding needs even splits)."""
    import jax.numpy as jnp

    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - size)
    return jnp.pad(x, pads, constant_values=fill)
