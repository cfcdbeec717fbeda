"""Isolate the frontend bench's host-side losses: the device-rate ceiling
(scripts/bench_frontend_parts.py measures the per-scan cost inside a
chunk) vs the bench.py headline.

Times the SAME workload three ways:
  A. bench.py form: per-chunk jnp.asarray transfers, chained dispatch
  B. pre-staged: all chunk inputs moved to device BEFORE timing
  C. pre-staged + K=128 chunks

Run (from the repo root): PYTHONPATH=. python scripts/bench_frontend_host.py
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.run.frontend import frontend_init, make_chunk_fn


def time_variant(name, cfg, odom_np, ranges_np, prestage: bool):
    K = cfg.chunk
    T = (len(odom_np) // K) * K
    n_chunks = T // K
    chunk_fn = make_chunk_fn(cfg)
    state = frontend_init(cfg, start_pose=odom_np[0], start_odom=odom_np[0])
    if prestage:
        od = [jnp.asarray(odom_np[s : s + K]) for s in range(0, T, K)]
        rg = [jnp.asarray(ranges_np[s : s + K]) for s in range(0, T, K)]
        jax.block_until_ready(rg[-1])
        state, tr, sc = chunk_fn(state, od[0], rg[0])
        np.asarray(tr)
        t0 = time.perf_counter()
        for i in range(1, n_chunks):
            state, tr, sc = chunk_fn(state, od[i], rg[i])
        np.asarray(tr)
        dt = time.perf_counter() - t0
    else:
        state, tr, sc = chunk_fn(
            state, jnp.asarray(odom_np[:K]), jnp.asarray(ranges_np[:K])
        )
        np.asarray(tr)
        t0 = time.perf_counter()
        for i in range(1, n_chunks):
            s = i * K
            state, tr, sc = chunk_fn(
                state, jnp.asarray(odom_np[s : s + K]),
                jnp.asarray(ranges_np[s : s + K]),
            )
        np.asarray(tr)
        dt = time.perf_counter() - t0
    done = (n_chunks - 1) * K
    print(json.dumps({
        "variant": name, "scans_per_sec": round(done / dt, 1),
        "ms_per_scan": round(dt / done * 1e3, 4), "chunk": K,
    }), flush=True)


def main():
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=1024, width=1024, resolution=0.05,
                        ray_samples=256, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.05, seed=0)
    odom_np = np.asarray(log["odom"], np.float32)
    ranges_np = np.asarray(log["ranges"], np.float32)
    print(f"backend={jax.default_backend()} T={len(odom_np)}", flush=True)

    time_variant("A bench form (K=64, per-chunk transfer)", cfg,
                 odom_np, ranges_np, prestage=False)
    time_variant("B pre-staged (K=64)", cfg, odom_np, ranges_np,
                 prestage=True)
    cfg128 = dataclasses.replace(cfg, chunk=128)
    time_variant("C pre-staged (K=128)", cfg128, odom_np, ranges_np,
                 prestage=True)
    time_variant("D bench form (K=128)", cfg128, odom_np, ranges_np,
                 prestage=False)


if __name__ == "__main__":
    main()
