"""The device a measurement runs on, and the refusal to measure without
a GPU (a number taken on the CPU is never reported as a device number)."""

from __future__ import annotations

import subprocess


def require_gpu(devices) -> dict:
    """{"platform", "kind", "count"} of `devices`; SystemExit unless they
    are GPUs."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found (JAX platform {plat!r}); this "
                         "measures the card and does not fall back")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def nvidia_smi() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip()
