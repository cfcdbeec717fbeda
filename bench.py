"""Benchmark: frontend scan-matching throughput (scans/s) on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference is a pure-Python correlative matcher; it publishes
no numbers (BASELINE.md). vs_baseline is MEASURED each run against the
NumPy reference-style comparator (tests/numpy_reference.py, SURVEY.md §6)
configured to the SAME workload shape (1024^2 grid @ 0.05 m, 180 beams,
cell-step search window, 13 theta steps) on the same log — a few scans
timed on this host's CPU (~1 s). Note this comparator is beam-VECTORIZED
NumPy; the actual reference loops per beam per candidate in pure Python,
so the measured baseline is a conservative (fast) stand-in.

Measures the GPU: refuses to run when JAX's backend is not a GPU, and
prints the device (platform, kind, count, card name and power limit) with
the result.
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.device import describe, require_gpu, setup_compile_cache
from slam2d_tpu.run.frontend import frontend_init, make_chunk_fn


def measure_reference_baseline(log, n_prime: int = 30, n_time: int = 3):
    """Measured comparator scans/s at the bench workload shape."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from numpy_reference import NumpyRefSLAM

    ref = NumpyRefSLAM(
        size=1024, resolution=0.05, center=(10.0, 10.0),
        n_beams=180, max_range=12.0,
        search_xy=0.3, search_step=0.05,
        search_theta=0.15, theta_step=0.025,
    )
    odom = np.asarray(log["odom"])
    ranges = np.asarray(log["ranges"])
    for t in range(n_prime):       # non-trivial map before timing
        ref.update(odom[t], ranges[t])
    t0 = time.perf_counter()
    for t in range(n_prime, n_prime + n_time):
        p, _ = ref.match(odom[t], ranges[t])
        ref.update(p, ranges[t])
    return n_time / (time.perf_counter() - t0)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--score-impl", default=None,
                    help="MatcherConfig.score_impl override "
                         "(gather | mxu | mxu_int8 | emx — for scorer A/Bs)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="scans per device chunk (per-chunk host overhead "
                         "amortizes with larger chunks)")
    ap.add_argument("--skip-offline", action="store_true",
                    help="skip the offline single-dispatch secondary "
                         "metric (saves ~2 min of whole-log compiles in "
                         "A/B sessions)")
    ap.add_argument("--chunks-per-dispatch", type=int, default=None,
                    help="FrontendConfig.chunks_per_dispatch override "
                         "(M chunks per device dispatch via a nested "
                         "scan — for A/Bs)")
    args = ap.parse_args()
    require_gpu()
    setup_compile_cache()

    # CARMEN-like sensor, production-ish grid (51.2 m @ 5 cm cells).
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=1024, width=1024, resolution=0.05, ray_samples=256,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(
            search_xy=0.3, search_theta=0.15, n_theta=13,
            **({"score_impl": args.score_impl} if args.score_impl else {}),
        ),
        chunk=args.chunk,
        match_min_motion=0.25,   # fine-res tuning (see FrontendConfig note)
        **({"chunks_per_dispatch": args.chunks_per_dispatch}
           if args.chunks_per_dispatch is not None else {}),
    )

    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.05, seed=0)
    odom = jnp.asarray(log["odom"])
    ranges = jnp.asarray(log["ranges"])
    # M chunks per dispatch via the nested-scan program (bit-identical to
    # M single-chunk dispatches — see FrontendConfig.chunks_per_dispatch)
    M = max(1, cfg.chunks_per_dispatch)
    group = cfg.chunk * M
    T = (len(odom) // group) * group
    n_groups = T // group

    from slam2d_tpu.run.frontend import make_multichunk_fn

    fn = make_multichunk_fn(cfg) if M > 1 else make_chunk_fn(cfg)
    state = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])

    # Pre-stage the chunk inputs on device (the double-buffered input
    # prefetch any production feeder does), so host-to-device copies stay
    # out of the timed loop.
    if M > 1:
        od = [odom[s : s + group].reshape(M, cfg.chunk, 3)
              for s in range(0, T, group)]
        rg = [ranges[s : s + group].reshape(M, cfg.chunk, -1)
              for s in range(0, T, group)]
    else:
        od = [odom[s : s + group] for s in range(0, T, group)]
        rg = [ranges[s : s + group] for s in range(0, T, group)]
    jax.block_until_ready(rg[-1])

    # Warmup: compile + one group; np.asarray drains the dispatch queue
    # before timing starts.
    state, tr, sc = fn(state, od[0], rg[0])
    np.asarray(tr)

    t0 = time.perf_counter()
    done = 0
    for i in range(1, n_groups):
        state, tr, sc = fn(state, od[i], rg[i])
        done += group
    np.asarray(tr)  # hard sync
    dt = time.perf_counter() - t0

    scans_per_sec = done / dt

    # OFFLINE single-dispatch secondary metric: the whole log in ONE
    # device program (bit-identical outputs, single dispatch — useful for
    # embedding), reported for tracking.
    offline_sps = None
    if not args.skip_offline:
        from slam2d_tpu.run.frontend import make_offline_fn

        offline_fn = make_offline_fn(cfg)
        od_full = odom[:T]
        rg_full = ranges[:T]
        st_off = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])
        st_off, tr_off, _ = offline_fn(st_off, od_full, rg_full)  # compile
        np.asarray(tr_off)
        best = float("inf")
        for _ in range(3):   # min-of-3: the first post-compile run measures
            st_off = frontend_init(cfg, start_pose=odom[0],
                                   start_odom=odom[0])
            t0 = time.perf_counter()
            st_off, tr_off, _ = offline_fn(st_off, od_full, rg_full)
            np.asarray(tr_off)
            rep = time.perf_counter() - t0
            print(f"# offline rep {rep*1e3:.1f} ms", flush=True)
            best = min(best, rep)
        offline_sps = T / best
    ref_sps = measure_reference_baseline(log)
    # report the kernels that actually ran ("auto" resolves to the plain
    # XLA paths: gather scorer, sparse scatter-add update)
    from slam2d_tpu.grid.occupancy import resolve_update_impl
    from slam2d_tpu.match.correlative import _resolve_impl

    print(
        json.dumps(
            {
                "metric": "frontend_scans_per_sec",
                "value": round(scans_per_sec, 2),
                "unit": "scans/s",
                "vs_baseline": round(scans_per_sec / ref_sps, 2),
                "mode": "streaming",
                "chunks_per_dispatch": M,
                **({"offline_scans_per_sec": round(offline_sps, 2)}
                   if offline_sps is not None else {}),
                "reference_scans_per_sec": round(ref_sps, 3),
                "update_impl": resolve_update_impl(cfg.grid),
                "score_impl": _resolve_impl(cfg.matcher.score_impl),
                "fine_theta_bins": cfg.matcher.fine_theta_bins,
                "device": describe(),
            }
        )
    )


if __name__ == "__main__":
    main()
