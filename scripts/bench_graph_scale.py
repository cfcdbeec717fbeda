"""Pose-graph optimizer wall time vs keyframe count (VERDICT r3 item 6
"measure optimize wall time vs K"): dense Cholesky vs block-Schur vs the
round-4 hierarchical matrix-free solver on serpentine multi-loop graphs.

Dense materializes [3K, 3K] (151 MB f32 at K=4096) and its f32 accuracy
collapses past ~1-2k (chain condition ~ K^2); hier's anchor-graph stage
keeps the dense solve at K/stride nodes. Each point reports wall time of
the SECOND call (compile excluded) and the trajectory error reduction.

Run (CPU): python scripts/bench_graph_scale.py
Run (GPU, from the repo root): PYTHONPATH=. python scripts/bench_graph_scale.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from tests.test_sparse_graph import _serpentine_graph


def time_opt(fn, g, cfg, reps=3):
    out, chi = fn(g, cfg)          # compile
    np.asarray(out.poses)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, chi = fn(g, cfg)
        np.asarray(out.poses)
    dt = (time.perf_counter() - t0) / reps
    return dt, out, float(chi)


def main():
    from slam2d_tpu.graph.schur import optimize_schur
    from slam2d_tpu.graph.se2_graph import optimize
    from slam2d_tpu.graph.sparse import optimize_cg, optimize_hier

    print(f"backend={jax.default_backend()}", flush=True)
    for K in (512, 1024, 2048, 4096, 16384):
        n_loops = max(10, K // 34)
        g, gt, est, cfg = _serpentine_graph(K, n_loops=n_loops, drift=0.01)
        cfg = dataclasses.replace(cfg, sparse_max_loops=128)
        err0 = float(np.sqrt(np.mean(
            np.sum((est[:, :2] - gt[:, :2]) ** 2, axis=1))))
        row = {"K": K, "loops": n_loops, "err0": round(err0, 3)}
        solvers = {
            "dense": optimize,
            "schur": lambda g_, c_: optimize_schur(g_, c_, n_blocks=8),
            "hier": optimize_hier,
        }
        if K > 2048:
            # dense at 4096 = 151 MB H per GN iteration and f32-collapsed
            # accuracy; report hier/schur only
            solvers.pop("dense")
        if K > 4096:
            solvers.pop("schur", None)   # block-Schur NaNs with K (r4 table)
        for name, fn in solvers.items():
            try:
                dt, out, chi = time_opt(fn, g, cfg)
                err = float(np.sqrt(np.mean(np.sum(
                    (np.asarray(out.poses)[:, :2] - gt[:, :2]) ** 2,
                    axis=1))))
                row[name + "_ms"] = round(dt * 1e3, 1)
                row[name + "_err"] = round(err, 4)
            except Exception as e:  # noqa: BLE001 — record, keep table
                row[name + "_ms"] = f"failed: {type(e).__name__}"
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
