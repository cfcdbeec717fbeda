"""optimize_hier accuracy vs an f64 sparse direct-solve reference
(VERDICT r4 item 6: "drive optimize_hier to the accuracy floor").

The f64 reference is a scipy.sparse Gauss-Newton with analytic SE(2)
Jacobians (the standard g2o 2D formulation — identical residual
e = t2v(Z^-1 (Xi^-1 Xj)) to graph/se2_graph.py) and a SuperLU direct
solve per iteration, run to convergence. NOTE the serpentine family's
measurements are NOISE-FREE (only the initial guess drifts), so the
optimum coincides with ground truth and err-vs-gt measures pure SOLVER
convergence — the f64 40-iteration error (~3e-5 at K=4096) is numerical
noise, and matching it means the f32 hierarchical solve converged to
the optimum.

Reported per K: err0 (odometry), err_f64 (floor), err_hier and
err/floor ratio for 1 and 2 V-cycles, wall times.

Run (CPU): python scripts/bench_hier_floor.py [--k 4096 16384 65536]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def f64_reference(est, edges_ij, edges_z, omegas, iters=10, damping=1e-6):
    """f64 sparse GN; returns optimized poses [K, 3]."""
    K = est.shape[0]
    x = est.astype(np.float64).copy()
    ei = edges_ij[:, 0].astype(np.int64)
    ej = edges_ij[:, 1].astype(np.int64)
    z = edges_z.astype(np.float64)
    om = omegas.astype(np.float64)

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    for _ in range(iters):
        ti, tj = x[ei], x[ej]
        ci, si = np.cos(ti[:, 2]), np.sin(ti[:, 2])
        cz, sz = np.cos(z[:, 2]), np.sin(z[:, 2])
        dx = tj[:, 0] - ti[:, 0]
        dy = tj[:, 1] - ti[:, 1]
        # d = R_i^T (t_j - t_i);  e_t = R_z^T (d - t_z)
        d0 = ci * dx + si * dy
        d1 = -si * dx + ci * dy
        u0 = d0 - z[:, 0]
        u1 = d1 - z[:, 1]
        e = np.stack([
            cz * u0 + sz * u1,
            -sz * u0 + cz * u1,
            wrap(tj[:, 2] - ti[:, 2] - z[:, 2]),
        ], axis=1)                                        # [E, 3]
        E = e.shape[0]
        # A = de/dxi, B = de/dxj (g2o 2D closed forms)
        RzT_RiT = np.zeros((E, 2, 2))
        RzT_RiT[:, 0, 0] = cz * ci - sz * si
        RzT_RiT[:, 0, 1] = cz * si + sz * ci
        RzT_RiT[:, 1, 0] = -(sz * ci + cz * si)
        RzT_RiT[:, 1, 1] = -sz * si + cz * ci
        # dR_i^T/dth (t_j - t_i)
        g0 = -si * dx + ci * dy
        g1 = -ci * dx - si * dy
        A = np.zeros((E, 3, 3))
        A[:, :2, :2] = -RzT_RiT
        A[:, 0, 2] = cz * g0 + sz * g1
        A[:, 1, 2] = -sz * g0 + cz * g1
        A[:, 2, 2] = -1.0
        B = np.zeros((E, 3, 3))
        B[:, :2, :2] = RzT_RiT
        B[:, 2, 2] = 1.0

        AtO = np.einsum("eji,ejk->eik", A, om)
        BtO = np.einsum("eji,ejk->eik", B, om)
        Hii = np.einsum("eij,ejk->eik", AtO, A)
        Hij = np.einsum("eij,ejk->eik", AtO, B)
        Hjj = np.einsum("eij,ejk->eik", BtO, B)
        bi = np.einsum("eij,ej->ei", AtO, e)
        bj = np.einsum("eij,ej->ei", BtO, e)

        # assemble COO
        r3 = np.arange(3)
        E3 = (e.shape[0], 3, 3)
        bri = np.broadcast_to((3 * ei)[:, None, None] + r3[None, :, None], E3)
        bci = np.broadcast_to((3 * ei)[:, None, None] + r3[None, None, :], E3)
        brj = np.broadcast_to((3 * ej)[:, None, None] + r3[None, :, None], E3)
        bcj = np.broadcast_to((3 * ej)[:, None, None] + r3[None, None, :], E3)
        rows = np.concatenate([
            bri.ravel(), bri.ravel(), brj.ravel(), brj.ravel(),
        ])
        cols = np.concatenate([
            bci.ravel(), bcj.ravel(), bci.ravel(), bcj.ravel(),
        ])
        vals = np.concatenate([
            Hii.ravel(), Hij.ravel(),
            np.swapaxes(Hij, 1, 2).ravel(), Hjj.ravel(),
        ])
        H = sp.coo_matrix(
            (vals, (rows, cols)), shape=(3 * K, 3 * K)
        ).tocsc()
        b = np.zeros(3 * K)
        np.add.at(b, (3 * ei[:, None] + r3[None, :]).ravel(), bi.ravel())
        np.add.at(b, (3 * ej[:, None] + r3[None, :]).ravel(), bj.ravel())
        diag = np.full(3 * K, damping)
        diag[:3] = 1e8                         # gauge anchor (direct solve)
        H = H + sp.diags(diag)
        delta = spla.spsolve(H, -b)
        x = x + delta.reshape(K, 3)
        x[:, 2] = wrap(x[:, 2])
    return x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[4096, 16384, 65536])
    ap.add_argument("--cycles", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args()

    import jax

    # CPU solver study: pin the CPU backend before any device query
    jax.config.update("jax_platforms", "cpu")

    from slam2d_tpu.graph.sparse import optimize_hier
    from tests.test_sparse_graph import _serpentine_graph

    def err_of(poses, gt):
        return float(np.sqrt(np.mean(
            np.sum((np.asarray(poses)[:, :2] - gt[:, :2]) ** 2, axis=1)
        )))

    for K in args.k:
        n_loops = max(10, K // 34)
        g, gt, est, cfg = _serpentine_graph(K, n_loops=n_loops, drift=0.01)
        cfg = dataclasses.replace(cfg, sparse_max_loops=128)
        row = {"K": K, "loops": n_loops, "err0": round(err_of(est, gt), 4)}

        ne = int(g.n_edges)
        t0 = time.perf_counter()
        x64 = f64_reference(
            est,
            np.asarray(g.edges_ij)[:ne],
            np.asarray(g.edges_z)[:ne],
            np.asarray(g.edges_omega)[:ne],
            iters=40,   # to convergence: the serpentine's measurements
        )               # are noise-free, so the optimum is GT itself
        row["f64_s"] = round(time.perf_counter() - t0, 2)
        floor = err_of(x64, gt)
        row["err_f64"] = round(floor, 5)

        for c in args.cycles:
            ccfg = dataclasses.replace(cfg, sparse_hier_cycles=c)
            g2, chi = optimize_hier(g, ccfg)       # compile
            np.asarray(g2.poses)
            t0 = time.perf_counter()
            g2, chi = optimize_hier(g, ccfg)
            e = err_of(g2.poses, gt)
            row[f"hier{c}_s"] = round(time.perf_counter() - t0, 2)
            row[f"err_hier{c}"] = round(e, 5)
            row[f"ratio{c}"] = round(e / max(floor, 1e-9), 2)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
