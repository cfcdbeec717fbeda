"""Frontend ATE + throughput at bench.py's exact config on the current
backend — used to validate that a kernel/dispatch change doesn't shift
accuracy at the bench's full width.

Run (from the repo root): PYTHONPATH=. python scripts/bench_ate.py [impl] [seed] [fine_theta_bins]
  impl: optional GridConfig.update_impl override (auto|sparse|sparse_mxu|dense)
  fine_theta_bins: optional MatcherConfig.fine_theta_bins override (-1 = all)
  argv[4]: optional MatcherConfig.score_impl override (gather | mxu | mxu_int8 | emx)
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.frontend import frontend_init, make_chunk_fn


def main():
    impl = sys.argv[1] if len(sys.argv) > 1 else "auto"
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    ftb = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    simpl = sys.argv[4] if len(sys.argv) > 4 else "auto"
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=1024, width=1024, resolution=0.05, ray_samples=256,
            center_x=10.0, center_y=10.0, update_impl=impl,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13,
                              fine_theta_bins=ftb, score_impl=simpl),
        chunk=64,
        match_min_motion=0.25,
    )

    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.05, seed=seed)
    odom = jnp.asarray(log["odom"])
    ranges = jnp.asarray(log["ranges"])
    T = (len(odom) // cfg.chunk) * cfg.chunk
    n_chunks = T // cfg.chunk

    chunk_fn = make_chunk_fn(cfg)
    state = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])

    trajs = []
    state, tr, sc = chunk_fn(state, odom[: cfg.chunk], ranges[: cfg.chunk])
    trajs.append(np.asarray(tr))

    t0 = time.perf_counter()
    done = 0
    for i in range(1, n_chunks):
        s = i * cfg.chunk
        state, tr, sc = chunk_fn(
            state, odom[s : s + cfg.chunk], ranges[s : s + cfg.chunk]
        )
        trajs.append(tr)
        done += cfg.chunk
    trajs = [np.asarray(t) for t in trajs]  # hard sync
    dt = time.perf_counter() - t0

    traj = np.concatenate(trajs)
    gt = log["gt_poses"][:T]
    print(
        json.dumps(
            {
                "impl": impl, "seed": seed, "fine_theta_bins": ftb,
                "backend": jax.default_backend(),
                "scans_per_sec": round(done / dt, 1),
                "ate_slam_m": round(float(ate_rmse(traj, gt, align=False)), 4),
                "ate_odom_m": round(
                    float(ate_rmse(log["odom"][:T], gt, align=False)), 4
                ),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
