"""Isolated heavy-step program timings at FastSLAM-1000 shapes.

The gate-ablation profiler (bench_pf1000_parts.py) attributed ~10x more
per update EVENT in an update-only variant than inside the full run —
same _update_all, different enclosing program. This probe times
each stage-specialized program (U, R, RU) as a chained dispatch loop
(donation-friendly: state flows through) plus the bare shared_update and
light-chunk dispatches, so program cost separates from driver effects.

Run (from the repo root): PYTHONPATH=. python scripts/bench_heavy_step.py
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
)
from slam2d_tpu.pf.fastslam import (
    fastslam_init, make_heavy_step, make_light_chunk,
)


def chain_time(name, step_fn, state, odom_seq, ranges, iters=30):
    # warm
    state, out = step_fn(state, odom_seq[0], ranges)
    np.asarray(out[0])
    t0 = time.perf_counter()
    for i in range(iters):
        state, out = step_fn(state, odom_seq[i % len(odom_seq)], ranges)
    np.asarray(out[0])
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(json.dumps({"stage": name, "ms_per_dispatch": round(ms, 3)}),
          flush=True)
    return state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1000)
    ap.add_argument("--update-mode", default="auto")
    args = ap.parse_args()

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=512, width=512, resolution=0.1,
                        ray_samples=128, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32, bootstrap_dist=2.0,
    )
    pf = PFConfig(n_particles=args.particles, map_dtype="bfloat16",
                  refine_chunk=125, update_mode=args.update_mode)
    print(f"backend={jax.default_backend()} P={args.particles} "
          f"update_mode={args.update_mode}", flush=True)

    rng = np.random.default_rng(0)
    ranges = jnp.asarray(rng.uniform(1.0, 11.0, 180).astype(np.float32))
    # odometry steps that keep motion small (gates are static here anyway)
    odom_seq = [
        jnp.asarray(np.array([10.0 + 0.05 * i, 10.0, 0.01 * i], np.float32))
        for i in range(8)
    ]
    state = fastslam_init(cfg, pf, jax.random.PRNGKey(0),
                          start_pose=np.array([10.0, 10.0, 0.0], np.float32))
    state = state._replace(prev_odom=odom_seq[0] + 0.0)

    U = make_heavy_step(cfg, pf, False, True, False)
    R = make_heavy_step(cfg, pf, True, False, False)
    RU = make_heavy_step(cfg, pf, True, True, False)

    state = chain_time("U (update only)", U, state, odom_seq, ranges)
    state = chain_time("R (refine only)", R, state, odom_seq, ranges)
    state = chain_time("RU (refine+update)", RU, state, odom_seq, ranges)

    # bare shared/per-particle update dispatch, chained through donation
    from slam2d_tpu.pf.fastslam import _update_all

    upd = jax.jit(
        lambda lo, po: _update_all(lo, po, ranges, cfg, pf),
        donate_argnums=(0,),
    )
    lo = state.logodds
    po = state.poses
    lo = upd(lo, po)
    np.asarray(jnp.sum(lo[0].astype(jnp.float32)))
    t0 = time.perf_counter()
    iters = 30
    for _ in range(iters):
        lo = upd(lo, po)
    np.asarray(jnp.sum(lo[0].astype(jnp.float32)))
    print(json.dumps({
        "stage": "_update_all bare",
        "ms_per_dispatch": round((time.perf_counter() - t0) / iters * 1e3, 3),
    }), flush=True)
    # upd donated state.logodds — restore a live buffer before any later
    # stage passes `state` to a donating program again
    state = state._replace(logodds=lo)

    light = make_light_chunk(cfg, pf, 16)
    seg = jnp.stack([o for o in odom_seq] + [odom_seq[-1]] * 8)
    outs = light(state.poses, state.log_w, state.rng, state.prev_odom,
                 state.dist, state.since_update, state.since_match,
                 seg, jnp.int32(8))
    np.asarray(outs[6][:1])
    t0 = time.perf_counter()
    for _ in range(30):
        outs = light(state.poses, state.log_w, state.rng, state.prev_odom,
                     state.dist, state.since_update, state.since_match,
                     seg, jnp.int32(8))
    np.asarray(outs[6][:1])
    print(json.dumps({
        "stage": "light chunk (16)",
        "ms_per_dispatch": round((time.perf_counter() - t0) / 30 * 1e3, 3),
    }), flush=True)

    # the DRIVER's pattern: light(16) -> state._replace -> U -> ... — the
    # gate-ablation profiler attributes ~40 ms to a U event inside this
    # alternation while the chained U above costs 2.2 ms; reproduce it
    # here to decide whether the cost is program interplay (donation /
    # scheduling) or run_fastslam host-loop specifics
    def alternate_once(state):
        outs = light(state.poses, state.log_w, state.rng, state.prev_odom,
                     state.dist, state.since_update, state.since_match,
                     seg, jnp.int32(8))
        state = state._replace(
            poses=outs[0], rng=outs[1], prev_odom=outs[2], dist=outs[3],
            since_update=outs[4], since_match=outs[5],
        )
        state, out = U(state, odom_seq[0], ranges)
        return state, out

    state, out = alternate_once(state)
    np.asarray(out[0])
    t0 = time.perf_counter()
    for _ in range(30):
        state, out = alternate_once(state)
    np.asarray(out[0])
    print(json.dumps({
        "stage": "alternating light(16)+U period",
        "ms_per_dispatch": round((time.perf_counter() - t0) / 30 * 1e3, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
