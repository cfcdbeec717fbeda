"""Same-session A/B of the deferred accept (run/full_slam defer_accept)
on the bounded two-lap loop scenario — throughput varies from run to run
and card to card, so accept-path wins must be measured back-to-back in
one process.

Run (from the repo root): PYTHONPATH=. python scripts/bench_accept_ab.py
"""

from __future__ import annotations

import json
import time

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.full_slam import run_full_slam


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
    gt = log["gt_poses"]

    for defer in (False, True):
        run_full_slam(log, cfg, gcfg, defer_accept=defer)   # warm
        for rep in range(2):
            t0 = time.perf_counter()
            res = run_full_slam(log, cfg, gcfg, defer_accept=defer)
            dt = time.perf_counter() - t0
            kfate = float(ate_rmse(
                res.kf_poses, gt[np.asarray(res.kf_scan_idx)], align=False
            ))
            print(json.dumps({
                "defer_accept": defer, "rep": rep,
                "wall_s": round(dt, 2),
                "scans_per_sec": round(T / dt, 1),
                "n_loops": int(res.n_loops),
                "n_attempts": len(res.loop_attempts),
                "kf_ate_m": round(kfate, 3),
            }), flush=True)


if __name__ == "__main__":
    main()
