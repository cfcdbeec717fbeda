"""Benchmark: FastSLAM particle-filter throughput on one GPU (config 3).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device"};
baseline normalization as in bench.py (reference estimated ~1 scan/s, and
its particle filter would be N times slower still — we conservatively keep
the 1.0 scans/s baseline). Refuses to run when JAX's backend is not a GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.device import describe, require_gpu, setup_compile_cache
from slam2d_tpu.pf.fastslam import fastslam_init
from slam2d_tpu.run.fastslam_run import make_pf_chunk_fn

REFERENCE_SCANS_PER_SEC = 1.0


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--map-dtype", default="bfloat16")
    ap.add_argument("--refine-chunk", type=int, default=0)
    ap.add_argument("--update-impl", default="auto")
    ap.add_argument("--update-mode", default="auto",
                    help="PFConfig.update_mode (auto|shared|per_particle)")
    ap.add_argument("--update-theta-slots", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0, help="PF RNG seed")
    ap.add_argument("--resolution", type=float, default=0.1,
                    help="map cell size, m (0.05 = the frontend bench's "
                         "production res; doubles every window dim)")
    ap.add_argument("--grid", type=int, default=512,
                    help="per-particle map cells per side")
    ap.add_argument("--match-min-motion", type=float, default=None,
                    help="refinement motion gate, m (fine-res runs need "
                         "~0.25 — the frontend's documented tuning)")
    ap.add_argument("--update-subcell", type=int, default=1)
    ap.add_argument("--update-bilinear", action="store_true",
                    help="bilinear sub-cell image placement in the shared "
                         "update (PFConfig.update_bilinear)")
    ap.add_argument("--fuse-light-prefix", type=int, default=None,
                    help="PFConfig.fuse_light_prefix override (0 = unfused "
                         "host-gated dispatch; for same-session A/Bs)")
    ap.add_argument("--carve-shrink", type=float, default=None,
                    help="PFConfig.update_carve_shrink override")
    ap.add_argument("--snapped-endpoints", action="store_true",
                    help="disable update_exact_endpoints (the round-4 "
                         "xy-quantization fix) for A/Bs against the "
                         "round-3 snapped shared update")
    ap.add_argument("--anchor-dither", default=None,
                    help="PFConfig.update_anchor_dither "
                         "(off|random|theta_phase|both) -- carve-anchor /"
                         " slot-grid decorrelation A/Bs")
    ap.add_argument("--update-qstep-cells", type=float, default=0.5,
                    help="shared-update rotation quantization target in "
                         "cells at max range (PFConfig.update_qstep_cells; "
                         "halving it wants --update-theta-slots doubled)")
    # proposal noise ~2.5x the bench log's odometry noise (0.004/0.002
    # per step): the filter's motion model matched to the robot's spec.
    # The library defaults (0.04/0.02) target 10x noisier logs and make
    # the PF WORSE than this log's odometry (ate 0.31 vs 0.15) while
    # also resampling more.
    ap.add_argument("--noise-xy", type=float, default=0.01,
                    help="PF proposal noise (m/step)")
    ap.add_argument("--noise-theta", type=float, default=0.005)
    ap.add_argument("--ungated", action="store_true",
                    help="time the single-program lax.cond chunk form "
                         "instead of the host-gated dispatch (comparison)")
    args = ap.parse_args()
    require_gpu()
    setup_compile_cache()

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=args.grid, width=args.grid, resolution=args.resolution,
            ray_samples=int(128 * 0.1 / args.resolution),
            center_x=10.0, center_y=10.0, update_impl=args.update_impl,
        ),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32,
        bootstrap_dist=2.0,
        **({"match_min_motion": args.match_min_motion}
           if args.match_min_motion is not None else {}),
    )
    noise = {}
    if args.noise_xy is not None:
        noise["noise_xy"] = args.noise_xy
    if args.noise_theta is not None:
        noise["noise_theta"] = args.noise_theta
    pf = PFConfig(
        n_particles=args.particles, map_dtype=args.map_dtype,
        refine_chunk=args.refine_chunk, update_mode=args.update_mode,
        update_theta_slots=args.update_theta_slots,
        update_subcell=args.update_subcell,
        update_bilinear=args.update_bilinear,
        update_qstep_cells=args.update_qstep_cells,
        update_exact_endpoints=not args.snapped_endpoints,
        **({"update_carve_shrink": args.carve_shrink}
           if args.carve_shrink is not None else {}),
        **({"update_anchor_dither": args.anchor_dither}
           if args.anchor_dither is not None else {}),
        **({"fuse_light_prefix": args.fuse_light_prefix}
           if args.fuse_light_prefix is not None else {}),
        **noise,
    )

    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0]]
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.05, seed=0)
    odom = jnp.asarray(log["odom"])
    ranges = jnp.asarray(log["ranges"])
    T = (len(odom) // cfg.chunk) * cfg.chunk
    n_chunks = T // cfg.chunk

    extra = {}
    if args.ungated:
        state = fastslam_init(
            cfg, pf, jax.random.PRNGKey(0), start_pose=odom[0]
        )
        state = state._replace(prev_odom=odom[0] + 0.0)
        chunk_fn = make_pf_chunk_fn(cfg, pf)

        state, out = chunk_fn(state, odom[: cfg.chunk], ranges[: cfg.chunk])
        np.asarray(out[0])  # hard sync

        t0 = time.perf_counter()
        done = 0
        for i in range(1, n_chunks):
            s = i * cfg.chunk
            state, out = chunk_fn(
                state, odom[s : s + cfg.chunk], ranges[s : s + cfg.chunk]
            )
            done += cfg.chunk
        np.asarray(out[0])
        dt = time.perf_counter() - t0
        rate = done / dt
    else:
        # host-gated dispatch: one full warmup run compiles every stage
        # variant (heavy RU/R/U/boot + the light chunk), the second run
        # is timed end to end (np outputs of run_fastslam ARE the sync)
        from slam2d_tpu.run.fastslam_run import run_fastslam

        run_fastslam(log, cfg, pf, seed=args.seed)
        t0 = time.perf_counter()
        _, best_traj, _, _ = run_fastslam(log, cfg, pf, seed=args.seed)
        dt = time.perf_counter() - t0
        rate = len(log["odom"]) / dt
        from slam2d_tpu.metrics import ate_rmse

        extra = {
            "ate_m": round(
                float(ate_rmse(best_traj, log["gt_poses"], align=False)), 3
            ),
            "ate_odom_m": round(
                float(
                    ate_rmse(log["odom"], log["gt_poses"], align=False)
                ), 3
            ),
        }
    print(
        json.dumps(
            {
                "metric": f"fastslam{args.particles}_scans_per_sec",
                "value": round(rate, 2),
                "unit": "scans/s",
                "vs_baseline": round(rate / REFERENCE_SCANS_PER_SEC, 2),
                **extra,
                "device": describe(),
            }
        )
    )


if __name__ == "__main__":
    main()
