"""Endurance-accuracy diagnosis (VERDICT r4 item 2): instrument the
4-lap endurance scenario — per-lap loop attempt/accept density, per-lap
keyframe ATE, and the effect of a FINAL global re-optimize — to
attribute the kf ATE gap (round 4: 2.03 m vs odom 4.79, where two-lap
scenarios reach 0.09-0.14).

Run (CPU): python scripts/diag_endurance.py [--laps 4] [--step 0.03]
Run (GPU, from the repo root): PYTHONPATH=. python scripts/diag_endurance.py
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--step", type=float, default=0.03)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--optimizer", default="schur")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam2d_tpu.config import (
        FrontendConfig, GraphConfig, GridConfig, MatcherConfig, SensorConfig,
    )
    from slam2d_tpu.data.synth import endurance_log
    from slam2d_tpu.metrics import ate_rmse
    from slam2d_tpu.run.full_slam import run_full_slam

    span = 28.0
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=768, width=768, resolution=0.05,
                        ray_samples=256, center_x=span / 2,
                        center_y=span / 2),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )
    gcfg = GraphConfig(
        max_nodes=1024, max_edges=4096, keyframe_dist=0.8,
        loop_min_gap=30, loop_radius=3.0, loop_score_accept=0.35,
        loop_max_correction_xy=2.5, gn_iters=10, robust_kind="dcs",
    )
    print(f"backend={jax.default_backend()}", flush=True)
    world, log = endurance_log(cfg.sensor, span=span, laps=args.laps,
                               step=args.step, seed=0)
    T = len(log["odom"])
    gt = log["gt_poses"]
    odom_ate = float(ate_rmse(log["odom"], gt, align=False))
    print(json.dumps({"scans": T, "odom_ate": round(odom_ate, 3)}),
          flush=True)

    t0 = time.perf_counter()
    res = run_full_slam(log, cfg, gcfg, optimizer=args.optimizer)
    dt = time.perf_counter() - t0

    kf_idx = np.asarray(res.kf_scan_idx, int)
    kf_gt = gt[kf_idx]
    kf_poses = np.asarray(res.kf_poses)
    K = len(kf_idx)
    kf_ate = float(ate_rmse(kf_poses, kf_gt, align=False))
    print(json.dumps({
        "scans_per_sec": round(T / dt, 1), "n_keyframes": K,
        "n_loops": int(res.n_loops), "kf_ate": round(kf_ate, 3),
    }), flush=True)

    # ---- per-lap breakdown ------------------------------------------------
    lap_of_scan = np.minimum(
        (np.arange(T) * args.laps) // T, args.laps - 1
    )
    lap_of_kf = lap_of_scan[kf_idx]
    att = (np.asarray(res.loop_attempts)
           if len(res.loop_attempts) else np.zeros((0, 10)))
    # attempt row: [i, k_new, score, margin, corr_xy, corr_th, accepted,
    #               mr_x, mr_y, mr_th]
    for lap in range(args.laps):
        sel = lap_of_kf == lap
        if att.shape[0]:
            a_sel = lap_of_kf[np.clip(att[:, 1].astype(int), 0, K - 1)] == lap
            n_att = int(a_sel.sum())
            n_acc = int(att[a_sel, 6].sum())
            med_score = float(np.median(att[a_sel, 2])) if n_att else 0.0
        else:
            n_att = n_acc = 0
            med_score = 0.0
        err = np.hypot(*(kf_poses[sel, :2] - kf_gt[sel, :2]).T)
        print(json.dumps({
            "lap": lap, "keyframes": int(sel.sum()),
            "attempts": n_att, "accepts": n_acc,
            "med_score": round(med_score, 3),
            "kf_err_mean": round(float(err.mean()), 3) if sel.any() else None,
            "kf_err_max": round(float(err.max()), 3) if sel.any() else None,
        }), flush=True)

    # ---- gauge analysis ---------------------------------------------------
    # align=False ATE charges the GLOBAL rotation/translation the gauge
    # anchor freezes at node 0 — an early (bootstrap-phase) heading error
    # rotates the whole ring and NO loop closure can observe it (every
    # edge is relative). Aligned ATE + relations-RPE separate "SLAM
    # failed" from "the absolute frame is unobservable".
    ate_aligned = float(ate_rmse(kf_poses, kf_gt, align=True))

    def rel_pose(p, a, b):
        d = p[b, :2] - p[a, :2]
        c, s = np.cos(p[a, 2]), np.sin(p[a, 2])
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])

    rng = np.random.default_rng(0)
    rerr = []
    for _ in range(800):
        a, b = rng.integers(0, K, 2)
        if a == b:
            continue
        rerr.append(np.hypot(*(
            rel_pose(kf_poses, a, b) - rel_pose(kf_gt, a, b)
        )))
    print(json.dumps({
        "kf_ate_aligned": round(ate_aligned, 3),
        "rel_rmse_random_pairs": round(
            float(np.sqrt(np.mean(np.square(rerr)))), 3
        ),
        "err_vs_arc_head": [round(float(e), 2) for e in np.hypot(
            *(kf_poses[:8, :2] - kf_gt[:8, :2]).T)],
    }), flush=True)

    # ---- attempt truth labels --------------------------------------------
    if att.shape[0]:
        ii = att[:, 0].astype(int)
        kk = att[:, 1].astype(int)
        z_meas = att[:, 7:10]
        gi, gk = kf_gt[np.clip(ii, 0, K - 1)], kf_gt[np.clip(kk, 0, K - 1)]
        c, s = np.cos(gi[:, 2]), np.sin(gi[:, 2])
        d = gk[:, :2] - gi[:, :2]
        z_gt = np.stack([c * d[:, 0] + s * d[:, 1],
                         -s * d[:, 0] + c * d[:, 1],
                         (gk[:, 2] - gi[:, 2] + np.pi) % (2 * np.pi) - np.pi],
                        axis=1)
        err_xy = np.hypot(*(z_meas[:, :2] - z_gt[:, :2]).T)
        acc = att[:, 6] > 0.5
        print(json.dumps({
            "attempt_truth": {
                "n": int(att.shape[0]), "n_accepted": int(acc.sum()),
                "accepted_z_err_med": round(float(np.median(err_xy[acc])), 3)
                if acc.any() else None,
                "accepted_z_err_max": round(float(err_xy[acc].max()), 3)
                if acc.any() else None,
                "rejected_true_frac": round(float(
                    ((~acc) & (err_xy < 0.25)).sum() / max((~acc).sum(), 1)
                ), 3),
            }
        }), flush=True)

    # ---- save artifacts for offline iteration -----------------------------
    g0 = res.ckpt["graph"]
    np.savez(
        "/tmp/endurance_diag.npz",
        kf_poses=kf_poses, kf_gt=kf_gt, kf_idx=kf_idx, att=att,
        g_poses=np.asarray(g0.poses), g_node_mask=np.asarray(g0.node_mask),
        g_n_nodes=int(g0.n_nodes), g_edges_ij=np.asarray(g0.edges_ij),
        g_edges_z=np.asarray(g0.edges_z),
        g_edges_omega=np.asarray(g0.edges_omega),
        g_edge_mask=np.asarray(g0.edge_mask), g_n_edges=int(g0.n_edges),
    )

    # ---- effect of a FINAL global optimize --------------------------------
    # the checkpoint carries the TRUE incremental graph (nodes at the
    # final corrected poses, the chain z's the tracker measured, every
    # accepted loop edge). Re-solving it harder separates "the
    # incremental solves under-converged" (polish helps) from "the graph
    # lacks information" (polish is a no-op; recall/edges are the gap).
    from slam2d_tpu.graph import se2_graph, sparse as gsparse

    g = res.ckpt["graph"]
    for name, fn, extra in (
        ("dense_gn20", se2_graph.optimize, {"gn_iters": 20}),
        ("dense_gn40", se2_graph.optimize, {"gn_iters": 40}),
        ("hier2", gsparse.optimize_hier,
         {"gn_iters": 10, "sparse_hier_cycles": 2, "sparse_max_loops": 256}),
    ):
        c2 = dataclasses.replace(gcfg, **extra)
        g2, chi = fn(g, c2)
        out = np.asarray(g2.poses)[:K]
        ate2 = float(ate_rmse(out, kf_gt, align=False))
        print(json.dumps({"global_resolve": name, "kf_ate": round(ate2, 3),
                          "chi": float(chi)}), flush=True)


if __name__ == "__main__":
    main()
