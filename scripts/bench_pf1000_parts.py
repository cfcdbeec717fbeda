"""FastSLAM-1000 step decomposition by GATE ABLATION (VERDICT r1 item 1).

Instead of timing isolated dispatches (which miss scheduling overlap and
gating rates), run the REAL chunked driver at P=1000 bf16 with stages
disabled via their motion gates:

  none    — match & update gates set unreachably high: pure scan/carry
            overhead (noise, dead-reckoning, weight bookkeeping)
  update  — map integration at its real cadence, no refinement
  refine  — refinement (+ the resamples it triggers) at its real cadence,
            no map update
  all     — the production step (bench_pf configuration)

Per-scan cost attribution = differences between variants.

Run (from the repo root): PYTHONPATH=. python scripts/bench_pf1000_parts.py
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.pf.fastslam import fastslam_init
from slam2d_tpu.run.fastslam_run import make_pf_chunk_fn

BIG = 1e9


def bench_variant(name, cfg, pf, log, n_chunks=8, host_gated=True):
    K = cfg.chunk
    if not host_gated:
        odom = jnp.asarray(log["odom"])
        ranges = jnp.asarray(log["ranges"])
        state = fastslam_init(
            cfg, pf, jax.random.PRNGKey(0), start_pose=odom[0]
        )
        state = state._replace(prev_odom=odom[0] + 0.0)
        chunk_fn = make_pf_chunk_fn(cfg, pf)

        state, out = chunk_fn(state, odom[:K], ranges[:K])
        np.asarray(out[0])
        s0 = 4 * K
        state, out = chunk_fn(state, odom[s0 - K : s0], ranges[s0 - K : s0])
        np.asarray(out[0])

        t0 = time.perf_counter()
        done = 0
        for i in range(n_chunks):
            s = s0 + i * K
            state, out = chunk_fn(state, odom[s : s + K], ranges[s : s + K])
            done += K
        np.asarray(out[0])
        dt = time.perf_counter() - t0
    else:
        from slam2d_tpu.run.fastslam_run import run_fastslam

        # warmup segment long enough to leave bootstrap and compile every
        # stage variant; timed segment continues from its state
        s0 = max(8 * K, 256)
        done = n_chunks * K
        first = {k: v[:s0] for k, v in log.items()}
        second = {k: v[s0 : s0 + done] for k, v in log.items()}
        state, _, _, _ = run_fastslam(first, cfg, pf, seed=0)
        t0 = time.perf_counter()
        run_fastslam(second, cfg, pf, state=state)
        dt = time.perf_counter() - t0
    ms = dt / done * 1e3
    print(json.dumps({
        "variant": name, "ms_per_scan": round(ms, 3),
        "scans_per_sec": round(done / dt, 1),
    }), flush=True)
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1000)
    ap.add_argument("--refine-chunk", type=int, default=125)
    ap.add_argument("--map-dtype", default="bfloat16")
    ap.add_argument("--variants", nargs="+",
                    default=["none", "update", "refine", "all"])
    ap.add_argument("--update-mode", default="auto",
                    help="PFConfig.update_mode override "
                         "(auto|shared|per_particle|quantized_per_particle)")
    args = ap.parse_args()

    base = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=512, width=512, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32,
        bootstrap_dist=2.0,
    )
    pf = PFConfig(
        n_particles=args.particles, map_dtype=args.map_dtype,
        refine_chunk=args.refine_chunk, update_mode=args.update_mode,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0]]
    )
    log = simulate_log(world, wp, base.sensor, step=0.05, seed=0)

    cfgs = {
        "none": dataclasses.replace(
            base, match_min_motion=BIG, match_min_rot=BIG,
            map_update_min_motion=BIG, map_update_min_rot=BIG,
        ),
        "update": dataclasses.replace(
            base, match_min_motion=BIG, match_min_rot=BIG,
        ),
        "refine": dataclasses.replace(
            base, map_update_min_motion=BIG, map_update_min_rot=BIG,
        ),
        "all": base,
    }
    # event counts over the timed window (scans [s0, s0+done)) so the
    # per-SCAN attribution can be read per EVENT
    from slam2d_tpu.pf.fastslam import host_gate_flags

    K = base.chunk
    s0 = max(8 * K, 256)
    done = 8 * K
    for name in args.variants:
        flags = host_gate_flags(log["odom"], cfgs[name], log["odom"][0])
        w = flags[s0 : s0 + done]
        print(json.dumps({
            "variant": name, "timed_scans": done,
            "n_refine_events": int(w[:, 0].sum()),
            "n_update_events": int(w[:, 1].sum()),
        }), flush=True)

    results = {}
    for name in args.variants:
        results[name] = bench_variant(name, cfgs[name], pf, log)
    if all(k in results for k in ("none", "update", "refine", "all")):
        print(json.dumps({
            "attribution_ms_per_scan": {
                "overhead": round(results["none"], 3),
                "update": round(results["update"] - results["none"], 3),
                "refine+resample": round(
                    results["refine"] - results["none"], 3
                ),
                "all": round(results["all"], 3),
            }
        }), flush=True)


if __name__ == "__main__":
    main()
