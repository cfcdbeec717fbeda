"""Stage-level timing of the PF refinement match (bench_pf shapes, P=100):
window extract, blur (search-space build), coarse score, fine score, and
the emx sub-stages (one-hot build, E matmul, S2 shift stack, final matmul).

Run (from the repo root): PYTHONPATH=. python scripts/bench_refine_parts.py
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
from slam2d_tpu.grid.occupancy import scan_endpoints_local, world_to_cell
from slam2d_tpu.grid.window import extract_window, scan_window_cells
from slam2d_tpu.match.correlative import (
    build_search_space, coarse_space, score_offsets, _theta_offsets,
)
from scripts.bench_refine import build_state

P = 100


def timeit(name, fn, *args, iters=20):
    """Times fn; syncs via a SCALAR checksum so the host never transfers
    bulk outputs (fetching a [100, T, H, W] tensor would swamp any kernel
    timing). Returns fn's device outputs for chaining."""
    out = fn(*args)
    reduced = jax.jit(
        lambda o: jax.tree.reduce(
            lambda a, x: a + jnp.sum(x.astype(jnp.float32)), o, jnp.float32(0)
        )
    )
    np.asarray(reduced(out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    np.asarray(reduced(out))
    dt = (time.perf_counter() - t0) / iters
    print(json.dumps({"stage": name, "ms": round(dt * 1e3, 3)}), flush=True)
    return out


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
    g = cfg.grid
    win = scan_window_cells(g, cfg.sensor, m)
    print(f"backend={jax.default_backend()} window={win}", flush=True)

    @jax.jit
    def extract_all(maps, priors):
        def one(grid, prior):
            center = world_to_cell(prior[:2], g)
            gw, _ = extract_window(grid, center, win)
            return gw
        return jax.vmap(one)(maps, priors)

    windows = timeit("extract_window x100", extract_all, maps, priors)

    @jax.jit
    def blur_all(ws):
        return jax.vmap(lambda w: build_search_space(w, m, g.resolution))(ws)

    S_all = timeit("build_search_space (blur) x100", blur_all, windows)

    @jax.jit
    def coarse_all(Ss):
        return jax.vmap(lambda s: coarse_space(s, m.coarse_factor))(Ss)

    Sc_all = timeit("coarse max-pool x100", coarse_all, Sc := S_all)

    pts_local, valid = scan_endpoints_local(ranges, cfg.sensor)
    dthetas = jnp.asarray(_theta_offsets(m), jnp.float32)
    origin = (jnp.float32(g.origin_x), jnp.float32(g.origin_y))

    def mk_score(S_shape_coarse, impl, fine):
        f = m.coarse_factor
        if fine:
            offs = jnp.arange(-f, f + 1, dtype=jnp.int32)
            cell = g.resolution
        else:
            r_fine = int(round(m.search_xy / g.resolution))
            import math
            rc = int(math.ceil(r_fine / f))
            offs = jnp.arange(-rc, rc + 1, dtype=jnp.int32)
            cell = g.resolution * f

        @jax.jit
        def score_all(Ss, priors):
            return jax.vmap(
                lambda s, p: score_offsets(
                    s, p, pts_local, valid, dthetas, offs, offs,
                    cell, origin, bilinear=fine, impl=impl,
                    use_bf16=m.score_bf16,
                )
            )(Ss, priors)

        return score_all

    for impl in ("mxu", "emx"):
        timeit(f"coarse score [{impl}] x100",
               mk_score(None, impl, False), Sc_all, priors)
        timeit(f"fine score [{impl}] x100",
               mk_score(None, impl, True), S_all, priors)

    # emx sub-stages on the fine-pass shape
    H = W = win
    T, B = m.n_theta, cfg.sensor.n_beams
    f = m.coarse_factor
    R = C = 2 * f + 1
    rng = jax.random.PRNGKey(1)
    pos_row = jax.random.uniform(rng, (P, T, B), minval=20.0, maxval=H - 20.0)
    pos_col = pos_row + 3.0
    cdtype = jnp.bfloat16

    @jax.jit
    def onehots(pr, pc):
        def one(pr, pc):
            r0 = jnp.floor(pr).astype(jnp.int32)
            c0 = jnp.floor(pc).astype(jnp.int32)
            fr = pr - jnp.floor(pr)
            h_iota = jnp.arange(H, dtype=jnp.int32)
            w_iota = jnp.arange(W, dtype=jnp.int32)
            R1 = (
                (r0[:, :, None] == h_iota) * (1.0 - fr)[:, :, None]
                + ((r0 + 1)[:, :, None] == h_iota) * fr[:, :, None]
            ).astype(cdtype)
            C1 = (
                (c0[:, :, None] == w_iota) * (1.0 - fr)[:, :, None]
                + ((c0 + 1)[:, :, None] == w_iota) * fr[:, :, None]
            ).astype(cdtype)
            return R1, C1
        return jax.vmap(one)(pr, pc)

    R1, C1 = timeit("emx: one-hot build x100", onehots, pos_row, pos_col)

    @jax.jit
    def ebuild(R1, C1):
        def one(R1, C1):
            return jax.lax.dot_general(
                R1, C1, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            ).astype(cdtype)
        return jax.vmap(one)(R1, C1)

    E = timeit("emx: E matmul x100", ebuild, R1, C1)

    @jax.jit
    def s2build(Ss):
        def one(S):
            Sp = jnp.pad(S.astype(cdtype), ((0, R), (0, C)))
            return jnp.stack(
                [Sp[dr : dr + H, dc : dc + W]
                 for dr in range(R) for dc in range(C)]
            )
        return jax.vmap(one)(Ss)

    S2 = timeit("emx: S2 shift stack x100", s2build, S_all)

    @jax.jit
    def final(E, S2):
        def one(E, S2):
            return jax.lax.dot_general(
                E.reshape(T, H * W), S2.reshape(R * C, H * W),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        return jax.vmap(one)(E, S2)

    timeit("emx: final matmul x100", final, E, S2)


if __name__ == "__main__":
    main()
