"""Component timing of the FastSLAM step beyond refinement: vmapped map
update, resample copy, and the full chunk at bench_pf shapes (P=100).

Run (from the repo root): PYTHONPATH=. python scripts/bench_pf_parts.py
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
from slam2d_tpu.pf.fastslam import _resample_copy, _windowed_update
from scripts.bench_refine import build_state

P = 100


def timeit(name, fn, *args, iters=20):
    try:
        return _timeit(name, fn, *args, iters=iters)
    except Exception as e:
        print(json.dumps({"stage": name, "error": repr(e)[:200]}), flush=True)
        return None


def _timeit(name, fn, *args, iters=20):
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
    print(f"backend={jax.default_backend()} particles={P}", flush=True)

    import dataclasses

    def mk_update(update_impl):
        c = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, update_impl=update_impl)
        )

        @jax.jit
        def update_all(maps, priors):
            return jax.vmap(
                lambda g, p: _windowed_update(g, p, ranges, c)
            )(maps, priors)

        return update_all

    timeit("vmapped windowed update x100 [scatter]",
           mk_update("sparse"), maps, priors)
    timeit("vmapped windowed update x100 [mxu]",
           mk_update("sparse_mxu"), maps, priors)
    timeit("vmapped windowed update x100 [dense]",
           mk_update("dense"), maps, priors)

    anc = jnp.asarray(np.random.default_rng(0).integers(0, P, P), jnp.int32)

    @jax.jit
    def resample_all(maps, anc):
        return _resample_copy(maps, anc)

    timeit("resample map copy x100 (512^2 maps)", resample_all, maps, anc)


if __name__ == "__main__":
    main()
