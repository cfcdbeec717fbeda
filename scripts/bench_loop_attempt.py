"""Stage timing of one loop-closure attempt at bench_fullslam shapes:
submap rebuild scan, blurred-field build, wide-window match, peak
diagnostic, fused attempt_full, cached attempt.

Run (from the repo root): PYTHONPATH=. python scripts/bench_loop_attempt.py
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld
from slam2d_tpu.grid.occupancy import make_grid, integrate_scan
from slam2d_tpu.match.correlative import (
    build_search_space, match_scan, peak_uniqueness,
)
from slam2d_tpu.run.full_slam import (
    default_loop_matcher, default_submap_grid, make_loop_attempt_fns,
)


def timeit(name, fn, *args, iters=20):
    out = fn(*args)
    sync = jax.jit(
        lambda o: sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(o))
    )
    np.asarray(sync(out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    np.asarray(sync(out))
    dt = (time.perf_counter() - t0) / iters
    print(json.dumps({"stage": name, "ms": round(dt * 1e3, 2)}), flush=True)
    return out


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
    lm = default_loop_matcher(gcfg)
    sub_cfg = default_submap_grid(cfg)
    print(f"backend={jax.default_backend()} submap={sub_cfg.height}^2 "
          f"lm: xy={lm.search_xy} th={lm.search_theta} n_theta={lm.n_theta}",
          flush=True)

    world = SynthWorld.box_rooms(20.0)
    beams = np.asarray(sensor.beam_angles())
    cap = 8
    poses = np.zeros((cap, 3), np.float32)
    scans = np.zeros((cap, sensor.n_beams), np.float32)
    mask = np.zeros(cap, np.float32)
    rng = np.random.default_rng(0)
    for k in range(7):
        p = np.array([6.0 + 0.5 * k, 6.0, 0.1 * k])
        poses[k] = p - np.array([6.0, 6.0, 0.0])
        scans[k] = world.raycast(p, beams, sensor.max_range)
        mask[k] = 1.0
    ranges = jnp.asarray(scans[3])
    prior = jnp.asarray(poses[3] + rng.normal(0, 0.2, 3).astype(np.float32))
    poses_j, scans_j, mask_j = map(jnp.asarray, (poses, scans, mask))

    attempt_full, attempt_cached = make_loop_attempt_fns(cfg, lm, sub_cfg)
    grid, S, *_ = timeit(
        "attempt_full (rebuild+blur+match+margin)",
        attempt_full, poses_j, scans_j, mask_j, ranges, prior,
    )
    timeit("attempt_cached (match+margin)", attempt_cached,
           grid, S, ranges, prior)

    @jax.jit
    def rebuild_only(poses, scans, mask):
        def body(g, inp):
            p, r, m = inp
            return integrate_scan(g, p, r, sub_cfg, sensor, enable=m), None
        g, _ = jax.lax.scan(
            body, make_grid(sub_cfg), (poses, scans, mask)
        )
        return g

    timeit("submap rebuild (8-scan lax.scan)", rebuild_only,
           poses_j, scans_j, mask_j)

    bss = jax.jit(lambda g: build_search_space(g, lm, sub_cfg.resolution))
    timeit("build_search_space", bss, grid)

    ms = jax.jit(lambda g, S, r, p: match_scan(
        g, r, p, sub_cfg, lm, sensor, search_space=S))
    timeit("match_scan (wide)", ms, grid, S, ranges, prior)

    pu = jax.jit(lambda g, S, r, p: peak_uniqueness(
        g, r, p, sub_cfg, lm, sensor, search_space=S))
    timeit("peak_uniqueness", pu, grid, S, ranges, prior)


if __name__ == "__main__":
    main()
