"""Frontend stage profile at bench.py shapes (VERDICT r2 item 5).

Times each frontend_step stage INSIDE an on-device lax.scan loop (the
device_loop_time harness — immune to dispatch/fetch overheads):

  - light scan (all gates off: the per-scan floor)
  - match event, per scorer impl (gather / mxu / mxu_int8 / emx) and per S dtype
  - update event (windowed integrate + cached-field rebuild + writebacks)
  - the real chunk fn on a real log chunk (ground truth per-scan cost)

Run (from the repo root): PYTHONPATH=. python scripts/bench_frontend_parts.py
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid.occupancy import integrate_scan, world_to_cell
from slam2d_tpu.grid.window import (
    blur_halo_cells,
    extract_window,
    scan_window_cells,
    update_window_cells,
    write_window,
    write_window_blur_exact,
)
from slam2d_tpu.match.correlative import build_search_space, match_scan
from slam2d_tpu.run.frontend import frontend_init, make_chunk_fn


def device_loop_time(step, carry0, iters=30):
    @functools.partial(jax.jit, static_argnums=(1,))
    def loop(carry, n):
        def body(c, t):
            return step(c, t), ()

        out, _ = jax.lax.scan(body, carry, jnp.arange(n))
        return jax.tree.map(
            lambda x: jnp.sum(jnp.ravel(x)[:1].astype(jnp.float32)), out
        )

    def run(n):
        t0 = time.perf_counter()
        chk = loop(carry0, n)
        np.asarray(jax.tree.leaves(chk)[0])
        return time.perf_counter() - t0

    loop(carry0, 1), loop(carry0, iters)
    run(1), run(iters)
    t1 = min(run(1) for _ in range(3))
    tn = min(run(iters) for _ in range(3))
    return (tn - t1) / (iters - 1)


def out(name, ms):
    print(json.dumps({"stage": name, "ms": round(ms * 1e3, 3)}), flush=True)


def main():
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=1024, width=1024, resolution=0.05,
                        ray_samples=256, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )
    print(f"backend={jax.default_backend()}", flush=True)

    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.05, seed=0)
    odom = jnp.asarray(log["odom"])
    ranges_all = jnp.asarray(log["ranges"])

    # build a real mid-run state so the stages see production content
    chunk_fn = make_chunk_fn(cfg)
    state = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])
    for i in range(6):
        s = i * cfg.chunk
        state, tr, sc = chunk_fn(
            state, odom[s: s + cfg.chunk], ranges_all[s: s + cfg.chunk]
        )
    np.asarray(tr)
    scan0 = 6 * cfg.chunk
    pose_now = jnp.asarray(np.asarray(tr)[-1])
    ranges = ranges_all[scan0]
    # chunk_fn donates its input state: keep private copies for the
    # stage timings below (and a fresh state per chunk-timing carry)
    logodds = jnp.array(state.logodds)
    S_cached = jnp.array(state.search_space)
    import slam2d_tpu.run.frontend as _fe

    state_copy = _fe.FrontendState(*(jnp.array(x) for x in state))

    win = scan_window_cells(cfg.grid, cfg.sensor, cfg.matcher)
    uwin = update_window_cells(cfg.grid, cfg.sensor, cfg.matcher)
    print(f"win={win} uwin={uwin}", flush=True)

    # ---- real chunk (ground truth per-scan cost) --------------------------
    o_chunk = odom[scan0: scan0 + cfg.chunk]
    r_chunk = ranges_all[scan0: scan0 + cfg.chunk]

    def chunk_step(c, t):
        st, traj, sc = c[0], c[1], c[2]
        st2, traj2, sc2 = make_chunk_fn(cfg)(st, o_chunk, r_chunk)
        return (st2, traj2, sc2)

    t_chunk = device_loop_time(
        chunk_step, chunk_fn(state, o_chunk, r_chunk), iters=10
    )
    out(f"chunk[{cfg.chunk}] total", t_chunk)
    out("per-scan (chunk/K)", t_chunk / cfg.chunk)

    # ---- match event per impl --------------------------------------------

    for impl in ("gather", "mxu_int8", "mxu", "emx"):
        mcfg = dataclasses.replace(cfg.matcher, score_impl=impl)

        def match_once(c, t, mcfg=mcfg):
            prior = pose_now + jnp.stack(
                [1e-4 * (t % 3).astype(jnp.float32), 0.0 * c[0], 0.0]
            )
            center = world_to_cell(prior[:2], cfg.grid)
            Sw, (r0, c0) = extract_window(S_cached, center, win)
            origin = (
                cfg.grid.origin_x + c0.astype(jnp.float32) * cfg.grid.resolution,
                cfg.grid.origin_y + r0.astype(jnp.float32) * cfg.grid.resolution,
            )
            pose, score = match_scan(
                logodds, ranges, prior, cfg.grid, mcfg, cfg.sensor,
                search_space=Sw, origin_xy=origin,
            )
            return pose

        t_m = device_loop_time(match_once, jnp.zeros(3), iters=30)
        out(f"match event [{impl}]", t_m)

    # ---- update event ------------------------------------------------------
    def update_once(c, t):
        pose = pose_now + jnp.stack(
            [1e-4 * (t % 3).astype(jnp.float32), 0.0, 0.0]
        )
        center = world_to_cell(pose[:2], cfg.grid)
        gw, (r0, c0) = extract_window(c[0], center, uwin)
        gw = integrate_scan(
            gw, pose, ranges, cfg.grid, cfg.sensor, origin_rc=(r0, c0)
        )
        lo = write_window(c[0], gw, (r0, c0))
        Sw = build_search_space(gw, cfg.matcher, cfg.grid.resolution)
        halo = blur_halo_cells(cfg.matcher, cfg.grid.resolution)
        ss = write_window_blur_exact(c[1], Sw, (r0, c0), halo)
        return (lo, ss)

    t_u = device_loop_time(update_once, (logodds, S_cached), iters=30)
    out("update event (integrate+field+writeback)", t_u)

    # field rebuild alone
    gw0, (r00, c00) = extract_window(logodds, world_to_cell(pose_now[:2], cfg.grid), uwin)

    def field_once(c, t):
        Sw = build_search_space(
            c + 1e-6 * t.astype(jnp.float32), cfg.matcher, cfg.grid.resolution
        )
        return c + 0.0 * Sw[:1, :1].sum()

    t_f = device_loop_time(field_once, gw0, iters=30)
    out(f"field rebuild alone ({uwin}^2)", t_f)

    # ---- light scan (gates off: repeat identical odometry) ----------------
    o_still = jnp.tile(o_chunk[:1], (cfg.chunk, 1))
    r_still = jnp.tile(r_chunk[:1], (cfg.chunk, 1))

    def light_step(c, t):
        st2, traj2, sc2 = make_chunk_fn(cfg)(c[0], o_still, r_still)
        return (st2, traj2, sc2)

    t_l = device_loop_time(
        light_step, chunk_fn(state_copy, o_still, r_still), iters=10
    )
    out(f"light chunk[{cfg.chunk}] (no motion)", t_l)
    out("light per-scan", t_l / cfg.chunk)


if __name__ == "__main__":
    main()
