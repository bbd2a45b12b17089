"""Device times of the per-frame tracking step on the GPU.

Run on the card (fails without a GPU):

    python scripts/profile_tracking.py --out chiprun_out/profile.json

1. Prints the device (`platform`, `device_kind`, count) and the card's
   `nvidia-smi` name and power limit; every result carries them.
2. A/B inside the jitted tracking step at the bench shape (752×480, 1000
   features, 8 levels, 8192-landmark map from a rendered scene): the
   hand-written pose-LM kernel against the plain XLA pose LM, in the order
   A B B A, median of single-dispatch step latencies (each step ends in
   `block_until_ready`, as the live loop pays it).
3. One `jax.profiler` trace of each variant: device time per named stage
   (pyramid, frontend, select, describe, match, pose_lm), from the
   kernels' HLO metadata, and the device's busy share of the window.

Peak rates come from `PEAKS`, keyed by `device_kind`; an unknown kind is
an error, not a default.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit (bytes/s of HBM3, FLOP/s of the tensor cores and of the
# plain f32 units)
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_bytes_s=3.35e12, bf16_flop_s=989e12, tf32_flop_s=495e12,
        f32_flop_s=67e12,
        source="NVIDIA H100 SXM data sheet (dense, 700 W)"),
}
STAGES = ("pyramid", "frontend", "select", "describe", "match", "pose_lm")


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def frontend_min_bytes(height=480, width=752, n_levels=8, scale=1.2):
    """Least device-memory traffic of the packed FAST/NMS/blur stage: write
    the raw canvas, read it once, write score, keep and blur."""
    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.ops import pyramid as pyr_ops

    _, rows = ex.pack_layout(pyr_ops.level_shapes(height, width, n_levels,
                                                  scale))
    px = rows * width
    return px * (4 + 4 + 4 + 1 + 4)


def step_latencies(fn, args, n: int):
    import jax

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def build_variant(name: str):
    """(jitted step, args) of the tracking case: "default" (the shipped
    choice) or "xla_pose" (the plain XLA pose LM in place of the kernel)."""
    import jax

    from orb_slam3_ros2_tpu.backend import pose_opt, pose_opt_fused
    from orb_slam3_ros2_tpu.frontend import extractor as ex
    from orb_slam3_ros2_tpu.runtime import bench_eval

    saved = pose_opt_fused.choose_impl
    if name == "xla_pose":
        pose_opt_fused.choose_impl = lambda platform: pose_opt.optimize_pose
    ex.make_extractor.cache_clear()  # the jitted extractor re-traces
    try:
        step, args, _, _ = bench_eval.tracking_case()
        fn = jax.jit(step)
        jax.block_until_ready(fn(*args))  # compile inside the patch
    finally:
        pose_opt_fused.choose_impl = saved
        ex.make_extractor.cache_clear()
    return fn, args


def ab(variants: dict, n: int) -> dict:
    """Median step latency (ms) of each variant, run in the order A B B A."""
    (na, (fa, aa)), (nb, (fb, ab_)) = variants.items()
    times = {na: [], nb: []}
    for name, fn, args in ((na, fa, aa), (nb, fb, ab_), (nb, fb, ab_),
                           (na, fa, aa)):
        times[name].extend(step_latencies(fn, args, n))
    return {name + "_ms": 1e3 * statistics.median(t)
            for name, t in times.items()} | {"steps_each": len(times[na])}


def trace_step(fn, args, steps: int) -> dict:
    """Per-stage device time of `steps` steps from one profiler trace."""
    import jax

    hlo = fn.lower(*args).compile().as_text()
    with tempfile.TemporaryDirectory() as td:
        jax.profiler.start_trace(td)
        for _ in range(steps):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(td, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        br = stage_breakdown(path, hlo)
    br["stage_ms_per_step"] = {k: v / steps
                               for k, v in br["stage_ms_total"].items()}
    return br


def _hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the named-scope paths (op_name metadata) of
    the instruction and of the computation it calls (a fusion's body)."""
    comp_ops, instr_ops, calls = {}, {}, {}
    cur = None
    for line in hlo_text.splitlines():
        if " = " not in line and line.rstrip().endswith("{"):
            cur = line.split()[1 if line.startswith("ENTRY") else 0]
            cur = cur.lstrip("%")
            comp_ops[cur] = []
            continue
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not m:
            continue
        ops = re.findall(r'op_name="([^"]*)"', line)
        instr_ops[m.group(1)] = ops
        if cur is not None:
            comp_ops[cur].extend(ops)
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[m.group(1)] = c.group(1)
    # kernels in a trace are named after their instruction with "." -> "_"
    return {name.replace(".", "_"): ops + comp_ops.get(calls.get(name, ""),
                                                         [])
            for name, ops in instr_ops.items()}


def _stage_of(paths, kernel_name: str) -> str:
    votes = {}
    for path in paths:
        for s in STAGES:
            if f"/{s}/" in f"/{path}/":
                votes[s] = votes.get(s, 0) + 1
    if votes:
        return max(votes, key=votes.get)
    # a hand-written kernel is named after its stage ("pose_lm_fused")
    return next((s for s in STAGES if kernel_name.startswith(s)), "other")


def stage_breakdown(xplane_path: str, hlo_text: str) -> dict:
    """Per-stage device time and device busy share from one trace."""
    from jax.profiler import ProfileData

    scopes = _hlo_scopes(hlo_text)
    per_stage = {s: 0.0 for s in STAGES + ("other",)}
    kernels = {}
    intervals = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                if "hlo_op" not in stats:
                    continue
                dur = ev.duration_ns / 1e6
                # a kernel split in several launches gets a "__<n>" suffix
                base = re.sub(r"__\d+$", "", ev.name.replace(".", "_"))
                stage = _stage_of(scopes.get(base, []), ev.name)
                per_stage[stage] += dur
                kernels[ev.name] = kernels.get(ev.name, 0.0) + dur
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    return {"stage_ms_total": per_stage,
            "busy_share_of_kernel_window": busy / window if window else None,
            "top_kernels_ms_total": dict(top)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/profile.json")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trace-steps", type=int, default=5)
    args = ap.parse_args()

    import jax

    from orb_slam3_ros2_tpu.utils.compile_cache import enable_compile_cache
    from orb_slam3_ros2_tpu.utils.device import nvidia_smi, require_gpu

    dev = require_gpu(jax.devices())
    enable_compile_cache()
    result = {"device": dev, "card": nvidia_smi(),
              "jax": jax.__version__}
    print(json.dumps(result), flush=True)

    variants = {name: build_variant(name)
                for name in ("default", "xla_pose")}
    result["pose_lm"] = ab(variants, args.steps)
    print(json.dumps(result["pose_lm"]), flush=True)
    result["trace"] = {name: trace_step(fn, fargs, args.trace_steps)
                       for name, (fn, fargs) in variants.items()}
    peaks = result["peaks"] = peaks_for(dev["kind"])
    fb = frontend_min_bytes()
    result["frontend_roofline"] = {
        "min_bytes": fb, "min_ms": 1e3 * fb / peaks["hbm_bytes_s"],
        "measured_ms": result["trace"]["default"]["stage_ms_per_step"][
            "frontend"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
