"""Fine-resolution PF constant study (VERDICT r2 item 6): sweep the
PF's proposal noise / weight sharpness / match gate at 0.05 m / 1024^2
the way round 1 tuned the frontend's match gate at fine res.

Round-2 finding: P=100 fine-res ATE 0.30 — worse than the coarse config
— with constants never studied at fine res.

Each point recompiles (weight_sharpness etc. are static jit config), so
the grid is small and targeted. Run points sequentially in ONE process
on the card.

Run (from the repo root): PYTHONPATH=. python scripts/bench_pf_finesweep.py
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.fastslam_run import run_fastslam


def run_point(log, gt, odom_ate, *, noise_xy, noise_theta, sharp, gate,
              seed=0, particles=100):
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=1024, width=1024, resolution=0.05,
                        ray_samples=256, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32, bootstrap_dist=2.0, match_min_motion=gate,
    )
    pf = PFConfig(
        n_particles=particles, map_dtype="bfloat16",
        noise_xy=noise_xy, noise_theta=noise_theta,
        weight_sharpness=sharp,
    )
    t0 = time.perf_counter()
    _, traj, n_eff, _ = run_fastslam(log, cfg, pf, seed=seed)
    dt = time.perf_counter() - t0
    ate = float(ate_rmse(traj, gt, align=False))
    print(json.dumps({
        "noise_xy": noise_xy, "noise_theta": noise_theta,
        "weight_sharpness": sharp, "match_min_motion": gate, "seed": seed,
        "ate": round(ate, 3), "odom_ate": round(odom_ate, 3),
        "scans_per_sec": round(len(traj) / dt, 1),
        "min_n_eff": round(float(np.min(n_eff)), 2),
    }), flush=True)
    return ate


def main():
    print(f"backend={jax.default_backend()}", flush=True)
    sensor = SensorConfig(n_beams=180, max_range=12.0)
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0]]
    )
    log = simulate_log(world, wp, sensor, step=0.05, seed=0)
    gt = log["gt_poses"]
    odom_ate = float(ate_rmse(log["odom"], gt, align=False))

    # round-2 baseline point (library-ish constants at fine res)
    base = dict(noise_xy=0.01, noise_theta=0.005, sharp=30.0, gate=0.25)
    results = {}
    results[tuple(base.values())] = run_point(log, gt, odom_ate, **base)
    # one-axis perturbations around it
    for nx, nt in ((0.005, 0.0025), (0.02, 0.01)):
        p = {**base, "noise_xy": nx, "noise_theta": nt}
        results[tuple(p.values())] = run_point(log, gt, odom_ate, **p)
    for sharp in (10.0, 60.0):
        p = {**base, "sharp": sharp}
        results[tuple(p.values())] = run_point(log, gt, odom_ate, **p)
    for gate in (0.15, 0.35):
        p = {**base, "gate": gate}
        results[tuple(p.values())] = run_point(log, gt, odom_ate, **p)

    # 3-seed validation at the best point (VERDICT r3 item 5 "done"
    # criterion: PF ATE < odom ATE on 3 seeds at 0.05 m)
    best = min(results, key=results.get)
    bp = dict(zip(("noise_xy", "noise_theta", "sharp", "gate"), best))
    print(json.dumps({"best_point": bp, "seed0_ate": results[best]}),
          flush=True)
    for seed in (1, 2):
        run_point(log, gt, odom_ate, **bp, seed=seed)


if __name__ == "__main__":
    main()
