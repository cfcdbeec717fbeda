"""Config-5 (full SLAM) throughput with repeated loop closures, with and
without the incremental post-loop map rebuild.

Scenario: two laps of the box_rooms tour — lap 2 re-enters lap-1
territory continuously, so the loop detector fires repeatedly and every
accepted loop triggers a post-correction map rebuild (the cost the
incremental rebuilder attacks). Reports end-to-end scans/s, loop count,
and trajectory ATE for:
  - incremental=True  (IncrementalTiledRebuilder, cached prefix replay)
  - incremental=False (naive full re-raycast per accepted loop)

loop_max_correction_xy is raised to 2.5 m: this is a long-drift run and
the implied corrections legitimately reach ~1.5-2 m (GraphConfig notes:
"scale up for long-drift datasets").

Run (from the repo root): PYTHONPATH=. python scripts/bench_fullslam.py
"""

from __future__ import annotations

import json
import time

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid.tiles import TileConfig
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.full_slam_tiled import run_full_slam_tiled
from slam2d_tpu.device import describe


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
    gt = np.asarray(log["gt_poses"])

    for inc in (True, False):
        # warm: one full run compiles every jitted stage (compiles must
        # not pollute the timing)
        run_full_slam_tiled(log, cfg, tcfg, gcfg, incremental_rebuild=inc)
        t0 = time.perf_counter()
        res = run_full_slam_tiled(log, cfg, tcfg, gcfg, incremental_rebuild=inc)
        dt = time.perf_counter() - t0
        kf_gt = gt[np.asarray(res.kf_scan_idx, int)]
        print(
            json.dumps(
                {
                    "variant": "incremental" if inc else "full_rebuild",
                    "scans": T,
                    "scans_per_sec": round(T / dt, 2),
                    "wall_s": round(dt, 2),
                    "n_loops": int(res.n_loops),
                    "loop_attempts": len(res.loop_attempts),
                    "kf_ate_m": round(
                        float(ate_rmse(res.kf_poses, kf_gt, align=False)), 3
                    ),
                    "device": describe(),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
