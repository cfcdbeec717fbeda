"""Microbench: PF per-particle refinement matching variants on the GPU.

The vmapped per-particle correlative match is FastSLAM-100's largest
stage (chip_smoke.py --profile times it). This script times
the isolated vmapped match (bench_pf.py's exact shapes: 100 particles,
512^2 maps at 0.1 m, 288^2 scan windows, 9 thetas) across scoring variants
so the winner can become the PF default.

Run (from the repo root): PYTHONPATH=. python scripts/bench_refine.py
"""

from __future__ import annotations

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
from slam2d_tpu.grid.occupancy import integrate_scan
from slam2d_tpu.pf.fastslam import _windowed_match

P = 100


def build_state(cfg):
    """100 particle maps with a realistic (non-empty) neighborhood: integrate
    a few scans so the blur/score paths see real structure."""
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.10, seed=0)
    grid = jnp.zeros((cfg.grid.height, cfg.grid.width), jnp.float32)
    for i in range(0, 40, 4):
        grid = integrate_scan(
            grid, jnp.asarray(log["odom"][i]), jnp.asarray(log["ranges"][i]),
            cfg.grid, cfg.sensor,
        )
    maps = jnp.tile(grid[None], (P, 1, 1))
    pose = jnp.asarray(log["odom"][40])
    rng = jax.random.PRNGKey(0)
    priors = pose[None, :] + 0.03 * jax.random.normal(rng, (P, 3))
    ranges = jnp.asarray(log["ranges"][40])
    return maps, priors.astype(jnp.float32), ranges


def time_variant(name, cfg, mcfg, maps, priors, ranges, iters=20):
    try:
        fn = jax.jit(
            jax.vmap(lambda g, p: _windowed_match(g, ranges, p, cfg, mcfg))
        )
        out = fn(maps, priors)
        np.asarray(out[0])  # hard sync (compile + first run)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(maps, priors)
        np.asarray(out[0])
        dt = (time.perf_counter() - t0) / iters
    except Exception as e:  # keep the sweep alive past a broken variant
        print(json.dumps({"variant": name, "error": repr(e)[:200]}), flush=True)
        return None
    print(json.dumps({
        "variant": name, "ms_per_refine": round(dt * 1e3, 3),
        "us_per_particle": round(dt * 1e6 / P, 1),
    }), flush=True)
    return dt


def main():
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=512, width=512, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32,
        bootstrap_dist=2.0,
    )
    maps, priors, ranges = build_state(cfg)
    m = cfg.matcher

    print(f"backend={jax.default_backend()} particles={P}", flush=True)
    time_variant(
        "emx_bf16 (endpoint-image)", cfg,
        dataclasses.replace(m, score_impl="emx"), maps, priors, ranges,
    )
    time_variant(
        "emx_f32", cfg,
        dataclasses.replace(m, score_impl="emx", score_bf16=False),
        maps, priors, ranges,
    )
    time_variant(
        "emx_bf16 coarse_factor=2", cfg,
        dataclasses.replace(m, score_impl="emx", coarse_factor=2),
        maps, priors, ranges,
    )
    time_variant("mxu_bf16 (current default)", cfg, m, maps, priors, ranges)
    time_variant(
        "mxu_f32", cfg, dataclasses.replace(m, score_bf16=False),
        maps, priors, ranges,
    )
    time_variant(
        "mxu_bf16 coarse_factor=1", cfg,
        dataclasses.replace(m, coarse_factor=1), maps, priors, ranges,
    )
    time_variant(
        "mxu_bf16 coarse_factor=2", cfg,
        dataclasses.replace(m, coarse_factor=2), maps, priors, ranges,
    )
    time_variant(
        "mxu_bf16 n_theta=5", cfg,
        dataclasses.replace(m, n_theta=5), maps, priors, ranges,
    )


if __name__ == "__main__":
    main()
