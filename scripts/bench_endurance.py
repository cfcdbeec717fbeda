"""Endurance target (VERDICT r2 item 10): full SLAM over the Intel-
statistics-matched long synthetic log (>= 10k scans, 180 beams, 3 laps
of a 28 m ring — loop-dense after lap 1), with host-memory bounds.

Records scans/s, keyframe ATE, loop accepts, and peak RSS. The real
Intel/ACES/MIT-Killian CARMEN logs remain the blocked input (no network,
not on disk); this is the stand-in endurance workload.

Run (from the repo root): PYTHONPATH=. python scripts/bench_endurance.py
"""

from __future__ import annotations

import json
import resource
import time

import numpy as np

import jax

from slam2d_tpu.config import (
    FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import endurance_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.full_slam import run_full_slam
from slam2d_tpu.device import describe


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main():
    span = 28.0
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=768, width=768, resolution=0.05,
                        ray_samples=256, center_x=span / 2,
                        center_y=span / 2),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )
    gcfg = GraphConfig(
        max_nodes=1024, max_edges=4096, keyframe_dist=0.8,
        loop_min_gap=30, loop_radius=3.0, loop_score_accept=0.35,
        loop_max_correction_xy=2.5, gn_iters=10, robust_kind="dcs",
    )
    print(f"backend={jax.default_backend()}", flush=True)
    # laps=4: laps=3 measured 9966 scans — just under the >= 10k target
    # (the docstring's ~13k estimate was off)
    world, log = endurance_log(cfg.sensor, span=span, laps=4, step=0.03,
                               seed=0)
    T = len(log["odom"])
    gt = log["gt_poses"]
    odom_ate = float(ate_rmse(log["odom"], gt, align=False))
    print(json.dumps({"device": describe(),
                      "scans": T, "odom_ate": round(odom_ate, 3),
                      "rss_mb_start": round(rss_mb(), 1)}), flush=True)
    assert T >= 10_000, T

    t0 = time.perf_counter()
    res = run_full_slam(log, cfg, gcfg, optimizer="schur")
    dt = time.perf_counter() - t0

    kf_idx = np.asarray(res.kf_scan_idx, int)
    kf_gt = gt[kf_idx]
    kf_ate = float(ate_rmse(res.kf_poses, kf_gt, align=False))
    odom_kf_ate = float(ate_rmse(log["odom"][kf_idx], kf_gt, align=False))
    # Gauge-separated accuracy (round-5 diagnosis): the unaligned ATE is
    # dominated by the global rotation an early heading error freezes
    # into the gauge anchor — unobservable to ANY pose-graph SLAM (every
    # measurement is relative; error grows linearly from 0 at the anchor
    # along the arc). Aligned ATE is the map-quality metric; the real
    # Radish benchmarks score relations-RPE for exactly this reason.
    kf_ate_aligned = float(ate_rmse(res.kf_poses, kf_gt, align=True))
    odom_aligned = float(ate_rmse(log["odom"][kf_idx], kf_gt, align=True))
    print(json.dumps({
        "metric": "endurance_full_slam_scans_per_sec",
        "value": round(T / dt, 2),
        "unit": "scans/s",
        "scans": T,
        "wall_s": round(dt, 1),
        "n_loops": int(res.n_loops),
        "n_keyframes": int(len(kf_idx)),
        "kf_ate": round(kf_ate, 3),
        "odom_kf_ate": round(odom_kf_ate, 3),
        "kf_ate_aligned": round(kf_ate_aligned, 3),
        "odom_kf_ate_aligned": round(odom_aligned, 3),
        "traj_finite": bool(np.isfinite(res.traj).all()),
        "rss_mb_peak": round(rss_mb(), 1),
    }), flush=True)


if __name__ == "__main__":
    main()
