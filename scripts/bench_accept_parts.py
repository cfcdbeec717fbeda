"""Phase breakdown of the full-SLAM ACCEPTED-loop path (graph transfer,
solve, retro-correction, map rebuild).

Installs run.full_slam.ACCEPT_TIMER (a PhaseTimer) and runs the two-lap
loop-closure scenario on the bounded driver. The timer adds hard syncs at
phase boundaries so device time is attributed to the phase that enqueued
it — the run itself is slower than production; only the per-phase
attribution is meaningful.

Run (from the repo root): PYTHONPATH=. python scripts/bench_accept_parts.py
"""

from __future__ import annotations

import json
import time

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.run import full_slam
from slam2d_tpu.utils.profiling import PhaseTimer


def main():
    sensor = SensorConfig(n_beams=180, max_range=12.0)
    cfg = FrontendConfig(
        sensor=sensor,
        grid=GridConfig(resolution=0.1, ray_samples=128),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=32,
        bootstrap_dist=2.0,
    )
    gcfg = GraphConfig(
        max_nodes=512, max_edges=2048, keyframe_dist=1.0,
        loop_min_gap=20, loop_radius=3.0, loop_score_accept=0.35,
        loop_max_correction_xy=2.5, gn_iters=10,
    )
    world = SynthWorld.box_rooms(20.0)
    lap = [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
           [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0]]
    wp = np.array(lap + [[3.0, 3.5]] + lap[1:] + [[3.0, 4.0]])
    log = simulate_log(
        world, wp, sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.006, seed=3,
    )
    T = len(log["odom"])

    full_slam.run_full_slam(log, cfg, gcfg)   # warm/compile (no timer)

    timer = PhaseTimer()
    full_slam.ACCEPT_TIMER = timer
    try:
        t0 = time.perf_counter()
        res = full_slam.run_full_slam(log, cfg, gcfg)
        dt = time.perf_counter() - t0
    finally:
        full_slam.ACCEPT_TIMER = None

    print(json.dumps({
        "scenario": "two_lap_bounded", "T": T, "wall_s": round(dt, 2),
        "scans_per_sec": round(T / dt, 2), "n_loops": int(res.n_loops),
        "n_attempts": len(res.loop_attempts),
        "kf_ate_note": "see bench_fullslam for accuracy",
    }), flush=True)
    n_acc = max(int(res.n_loops), 1)
    total = 0.0
    for name in sorted(timer.totals, key=timer.totals.get, reverse=True):
        t, n = timer.totals[name], timer.counts[name]
        if name != "accept/apply_correction":   # parent phase; avoid double count
            total += t
        print(json.dumps({
            "phase": name, "total_s": round(t, 3),
            "per_accept_ms": round(t / n_acc * 1e3, 1),
            "calls": n,
        }), flush=True)
    print(json.dumps({
        "phase": "SUM(leaf phases)", "per_accept_ms": round(total / n_acc * 1e3, 1),
        "n_accepts": int(res.n_loops),
    }), flush=True)


if __name__ == "__main__":
    main()
