"""Per-stage wall-clock tracing + jax.profiler capture (SURVEY.md §5).

The reference has no tracing at all (upstream ORB-SLAM3 only has the
optional `REGISTER_TIMES` compile flag); frames/s and BA iterations/s are
north-star metrics here (BASELINE.md), so the engine carries a lightweight
always-on stage timer:

    with trace.stage("pose_opt"):
        ...
    trace.report()   # {"pose_opt": {"n":..., "mean_ms":..., "p95_ms":...}}

Timers measure host wall-clock around dispatches — JAX dispatches
asynchronously, so a stage's time includes queued device work only if the
stage syncs (ours do: the host state machine reads back scalars). For device-level
truth use `capture(logdir)` which wraps `jax.profiler.trace` and produces a
TensorBoard/XProf trace of the XLA ops.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class StageTracer:
    """Aggregating wall-clock timer keyed by stage name. Negligible overhead
    (~1 µs/stage): two perf_counter calls and a list append."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        if self.enabled:
            self._samples[name].append(seconds)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in sorted(self._samples.items()):
            s = sorted(xs)
            n = len(s)
            out[name] = {
                "n": n,
                "total_ms": round(sum(s) * 1e3, 2),
                "mean_ms": round(sum(s) / n * 1e3, 3),
                "p50_ms": round(s[n // 2] * 1e3, 3),
                "p95_ms": round(s[min(n - 1, int(n * 0.95))] * 1e3, 3),
                "max_ms": round(s[-1] * 1e3, 3),
            }
        return out

    def reset(self):
        self._samples.clear()


@contextlib.contextmanager
def capture(logdir: str):
    """Device-level trace via jax.profiler (open in TensorBoard/XProf)."""
    import jax

    with jax.profiler.trace(logdir):
        yield
