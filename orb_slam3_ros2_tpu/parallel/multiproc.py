"""Multi-process (multi-host) distributed BA entry point.

The reference has no scale-out at all (its only "distribution" is ROS DDS
pub/sub inside one machine, `/root/reference/package.xml:11-24`); this
module is the multi-host story: each host runs one process,
`jax.distributed.initialize` forms the global runtime, and the
landmark-sharded Schur BA (`parallel/sharded_ba.py`) runs over the GLOBAL
mesh — the per-iteration psum of the reduced camera system is the only
cross-host traffic (O(K²·36) bytes, landmark elimination never leaves a
device), which keeps the payload small whether it crosses NVLink inside a
host or the network between hosts.

On a GPU host each process owns its own cards (`--local-devices N`:
process p takes local cards [pN, (p+1)N), see `mesh.init_distributed`).
Under JAX_PLATFORMS=cpu it runs with N processes × M virtual CPU devices
and Gloo collectives — the same program, sharding and collective
structure (SURVEY.md §4 prescribes this multi-process simulation).

Run as a module, once per process:

    python -m orb_slam3_ros2_tpu.parallel.multiproc \
        --process-id 0 --num-processes 2 --coordinator 127.0.0.1:9901 \
        --problem /tmp/problem.npz --out /tmp/out.npz --iters 10

`tests/test_multiprocess.py` drives 2 processes and checks the result is
identical to the single-process solver.
"""

from __future__ import annotations

import argparse
import json
import time


def _build_problem(path: str):
    import jax.numpy as jnp
    import numpy as np

    from orb_slam3_ros2_tpu.backend import ba as ba_mod

    d = np.load(path)
    return ba_mod.BAProblem(
        R=jnp.asarray(d["R"], jnp.float32),
        t=jnp.asarray(d["t"], jnp.float32),
        X=jnp.asarray(d["X"], jnp.float32),
        uv=jnp.asarray(d["uv"], jnp.float32),
        w=jnp.asarray(d["w"], jnp.float32),
        fixed=jnp.asarray(d["fixed"], bool),
        point_valid=jnp.asarray(d["point_valid"], bool),
    ), {k: float(d[k]) for k in ("fx", "fy", "cx", "cy")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9901")
    ap.add_argument("--problem", required=True, help="npz with BA problem")
    ap.add_argument("--out", required=True,
                    help="npz written by process 0 (R, t, cost, timing)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="devices per process: virtual CPU devices under "
                         "JAX_PLATFORMS=cpu, else this process's own "
                         "accelerators (0 = one)")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions (beyond the compile+warmup run)")
    args = ap.parse_args(argv)

    from orb_slam3_ros2_tpu.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(args.coordinator, args.num_processes,
                              args.process_id, args.local_devices)
    import jax
    import numpy as np

    from orb_slam3_ros2_tpu.parallel import sharded_ba

    problem, intr = _build_problem(args.problem)
    n_dev = len(jax.devices())
    mesh = mesh_mod.make_mesh(n_dev)

    ba = sharded_ba.make_sharded_ba(
        mesh, intr["fx"], intr["fy"], intr["cx"], intr["cy"],
        n_iters=args.iters)
    # replicated host arrays -> global landmark-sharded layout; each process
    # populates only its addressable shards
    p = sharded_ba.shard_problem(problem, mesh)

    out = ba(p)  # compile + warmup
    jax.block_until_ready(out.R)
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = ba(p)
        jax.block_until_ready(out.R)
        best = min(best, time.perf_counter() - t0)

    if args.process_id == 0:
        # R, t, cost are replicated -> fully addressable on process 0
        np.savez(
            args.out,
            R=np.asarray(out.R), t=np.asarray(out.t),
            cost=np.asarray(out.cost),
            wall_s=best, iters=args.iters,
            devices=n_dev, processes=args.num_processes,
        )
        print(json.dumps({
            "devices": n_dev, "processes": args.num_processes,
            "ba_iters_per_s": round(args.iters / best, 2),
            "final_cost": float(out.cost),
        }), flush=True)


if __name__ == "__main__":
    main()
