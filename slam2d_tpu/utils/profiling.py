"""Tracing / profiling utilities (SURVEY.md §7 "Tracing / profiling").

- `PhaseTimer`: named host-side phase accumulators (scan-match / update /
  resample / optimize) with a report string.
- `Throughput`: scans/s counter (the BASELINE driver metric).
- `trace`: context manager around `jax.profiler` for TensorBoard traces of
  the device timeline (viewable with tensorboard-plugin-profile).

Note on async dispatch: phase timers only mean something if the timed code
block ends at a sync point (block_until_ready / host transfer); callers are
responsible for that — `Throughput.mark_synced` documents the convention.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s  ({n}x, {t / n * 1e3:7.2f} ms avg)")
        return "\n".join(lines)


class Throughput:
    """scans/s counter; call mark_synced(n) after a hard device sync."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.n = 0

    def mark_synced(self, n_scans: int):
        self.n += n_scans

    @property
    def scans_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (TensorBoard 'profile' plugin format)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time_summary(logdir: str, top: int = 12) -> dict:
    """Reduce the newest `.xplane.pb` under `logdir` to device metrics:
    per device plane ("/device:GPU:N"), the window (first op start to
    last op end), the busy time (union of op intervals), the idle
    share, and the `top` "line: event" names by summed device duration
    (a plane's lines are its streams and XLA's op/module views, so the
    same time can show under several lines)."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        spans, per_name = [], defaultdict(int)
        for line in plane.lines:
            # module/step lines span whole programs, gaps included
            op_line = not any(w in line.name for w in ("Module", "Step"))
            for ev in line.events:
                if op_line:
                    spans.append((ev.start_ns, ev.end_ns))
                per_name[f"{line.name}: {ev.name}"] += ev.duration_ns
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        kernels = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
        out[plane.name] = {
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "top_events_ms": {k: v / 1e6 for k, v in kernels},
        }
    return out
