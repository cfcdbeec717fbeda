"""Attribute full-SLAM loop-scenario cost by differencing three runs of
the bench_fullslam two-lap scenario:

  A. no attempts   (loop_min_gap > n_keyframes: spatial gate never fires)
  B. attempts only (loop_score_accept = 2.0: every attempt rejected ->
                    submap rebuild + wide match cost, no optimize/rebuild)
  C. full          (accepts -> + optimize + retro-correct + map rebuild)

cost(attempts) ~= wall(B) - wall(A) over n_attempts(B)
cost(accepts)  ~= wall(C) - wall(B') where B' rescales attempt count.

Run (from the repo root): PYTHONPATH=. python scripts/bench_fullslam_parts.py
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid.tiles import TileConfig
from slam2d_tpu.run.full_slam_tiled import run_full_slam_tiled


def main():
    sensor = SensorConfig(n_beams=180, max_range=12.0)
    cfg = FrontendConfig(
        sensor=sensor,
        grid=GridConfig(resolution=0.1, ray_samples=128),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=32,
        bootstrap_dist=2.0,
    )
    tcfg = TileConfig(tile=256, n_slots=48, resolution=0.1)
    base = GraphConfig(
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

    variants = {
        "A_no_attempts": dataclasses.replace(base, loop_min_gap=100000),
        "B_attempts_rejected": dataclasses.replace(base, loop_score_accept=2.0),
        "C_full": base,
    }
    walls = {}
    for name, gcfg in variants.items():
        run_full_slam_tiled(log, cfg, tcfg, gcfg)   # warm/compile
        t0 = time.perf_counter()
        res = run_full_slam_tiled(log, cfg, tcfg, gcfg)
        dt = time.perf_counter() - t0
        walls[name] = (dt, len(res.loop_attempts), int(res.n_loops))
        print(json.dumps({
            "variant": name, "wall_s": round(dt, 2),
            "scans_per_sec": round(T / dt, 2),
            "n_attempts": len(res.loop_attempts),
            "n_loops": int(res.n_loops),
        }), flush=True)

    dA, _, _ = walls["A_no_attempts"]
    dB, nB, _ = walls["B_attempts_rejected"]
    dC, nC, nL = walls["C_full"]
    if nB:
        per_attempt = (dB - dA) / nB * 1e3
        print(json.dumps({"stage": "per_rejected_attempt_ms",
                          "ms": round(per_attempt, 1)}), flush=True)
    if nL:
        # C's attempts cost ~ the same per-attempt rate as B's
        attempt_cost = (dB - dA) / nB * nC if nB else 0.0
        per_accept = (dC - dA - attempt_cost) / nL * 1e3
        print(json.dumps({"stage": "per_accepted_loop_extra_ms",
                          "ms": round(per_accept, 1)}), flush=True)


if __name__ == "__main__":
    main()
