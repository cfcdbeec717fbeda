"""Chip smoke: drive slam2d's pipelines once on an NVIDIA GPU, through the
entry points a user calls, at the widths the benches use, and check the
answers against the repo's own references.

    python chip_smoke.py                  # one card: the five phases below
    python chip_smoke.py --cards 4        # four cards: the sharded paths only
    python chip_smoke.py --profile DIR    # also trace + time the stages

Phases (one card):
  1. frontend      run_frontend on bench.py's log and config (1024^2 grid at
                   0.05 m, 180 beams, 12 m, 13 theta, 64-scan chunks, 2 chunks
                   per dispatch), plus the CLI entry in process.
  2. parity        every score_impl against the gather scorer at "highest"
                   precision on the frontend map; gather match poses and the
                   sparse / dense map updates against tests/numpy_reference.py.
  3. fastslam      FastSLAM-100 and -1000 on bench_pf.py's config (512^2 bf16
                   maps at 0.1 m), auto modes and, at P=1000, the shared
                   modes, each against an ATE bound; bit-exact resample
                   copy and slot select.
  4. localize      run_localization on the phase-1 map and the global FFT
                   relocalization.
  5. full_slam     two-lap tour with loop closure, schur and hier solvers.

Every phase prints one JSON line (phase, pass, impl, accuracy numbers, wall
seconds including compile). The last line is {"ok": ..., "device": ...};
the exit code is 0 only if every phase passed. Without a GPU the script
exits 1 before running anything.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# widths of bench.py / bench_pf.py; a rehearsal on the CPU shrinks them
SIZE = {
    "frontend_grid": 1024,      # cells per side at 0.05 m
    "fullslam_grid": 512,       # cells per side at 0.05 m
    "pf_grid": 512,             # cells per side at 0.1 m
    "pf_small": 100,            # particles
    "pf_big": 1000,             # particles
    "copy_rows": 256,           # f32 [rows, pf_grid, pf_grid] copy check
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phases:
    """Runs named checks; a check returns (ok, detail) or raises."""

    def __init__(self):
        self.ok = True

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            ok, detail = fn()
        except Exception as e:  # reported as a failed phase, never hidden
            traceback.print_exc()
            ok, detail = False, {"error": f"{type(e).__name__}: {e}"}
        emit({"phase": name, "pass": bool(ok), **detail,
              "wall_s": round(time.perf_counter() - t0, 3)})
        self.ok &= bool(ok)


# --- configurations (bench.py / bench_pf.py widths) --------------------------

def bench_world():
    from slam2d_tpu.data.synth import SynthWorld

    return SynthWorld.box_rooms(20.0)


TOUR = np.array(
    [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
     [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
)


def frontend_cfg(grid=None):
    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
    )

    return FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=grid or SIZE["frontend_grid"],
                        width=grid or SIZE["frontend_grid"], resolution=0.05,
                        ray_samples=256, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )


def pf_cfg():
    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
    )

    return FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=SIZE["pf_grid"], width=SIZE["pf_grid"],
                        resolution=0.1, ray_samples=128, center_x=10.0,
                        center_y=10.0),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32, bootstrap_dist=2.0,
    )


def pf_params(P, **kw):
    from slam2d_tpu.config import PFConfig

    return PFConfig(n_particles=P, map_dtype="bfloat16",
                    noise_xy=0.01, noise_theta=0.005, **kw)


def ate(traj, gt):
    from slam2d_tpu.metrics import ate_rmse

    return float(ate_rmse(traj, gt, align=False))


# --- phase 1: frontend ---------------------------------------------------------

def phase_frontend(ctx):
    from slam2d_tpu.data.synth import simulate_log
    from slam2d_tpu.grid.occupancy import resolve_update_impl
    from slam2d_tpu.match.correlative import _resolve_impl
    from slam2d_tpu.run import cli
    from slam2d_tpu.run.frontend import run_frontend

    cfg = frontend_cfg()
    log = simulate_log(bench_world(), TOUR, cfg.sensor, step=0.05, seed=0)
    state, traj, _ = run_frontend(log, cfg)
    a, a_odom = ate(traj, log["gt_poses"]), ate(log["odom"], log["gt_poses"])
    ctx.update(cfg=cfg, log=log, logodds=state.logodds, odom_ate=a_odom)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--mode", "frontend", "--log", "synth", "--gt-ate",
                       "--grid-size", str(SIZE["frontend_grid"])])
    m = json.loads(buf.getvalue().strip().splitlines()[-1])
    ok = (a < a_odom and bool(np.isfinite(traj).all()) and rc == 0
          and np.isfinite(m["ate_m"]))
    return ok, {
        "impl": {"score": _resolve_impl(cfg.matcher.score_impl),
                 "update": resolve_update_impl(cfg.grid)},
        "scans": len(traj), "ate_m": a, "odom_ate_m": a_odom,
        "cli_rc": rc, "cli_ate_m": m["ate_m"],
        "cli_odom_ate_m": m["ate_odom_m"],
    }


# --- phase 2: parity against the plain references ------------------------------

# max |score - gather reference| per scorer, with the precision it ran at.
# Scores live in [-0.6, 1]; a score is a mean of bilinear field samples.
# bf16 rounds S (and emx's splat weights) by <= 2^-9 relative, TF32 by
# <= 2^-11, int8 by half its scale max|S|/127.
SCORERS = [
    ("gather", True, 1e-5, "f32 gather, no matmul"),
    ("mxu", True, 3e-3, "bf16 operands, f32 accumulate"),
    ("mxu", False, 1.5e-3, "f32 operands, default matmul precision (TF32)"),
    ("mxu_int8", True, 8e-3, "int8 operands, int32 accumulate"),
    ("emx", True, 6e-3, "bf16 operands, f32 accumulate"),
    ("emx", False, 2e-3, "f32 operands, default matmul precision (TF32)"),
]


def ref_score(ref, S, pose, ranges):
    """The reference matcher's objective (NumpyRefSLAM.match) at one pose:
    mean of its search space S at the hit endpoints."""
    hit = (ranges > 0.1) & (ranges < ref.max_range)
    ex = pose[0] + ranges * np.cos(ref.angles + pose[2])
    ey = pose[1] + ranges * np.sin(ref.angles + pose[2])
    r, c = ref._cells(ex, ey)
    ok = hit & (r >= 0) & (r < ref.size) & (c >= 0) & (c < ref.size)
    return S[r[ok], c[ok]].sum() / max(hit.sum(), 1)


def phase_parity(ctx):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from numpy_reference import NumpyRefSLAM

    from slam2d_tpu.grid.occupancy import (
        raycast_update, raycast_update_dense, scan_endpoints_local,
        world_to_cell,
    )
    from slam2d_tpu.grid.window import extract_window, scan_window_cells
    from slam2d_tpu.match.correlative import (
        _theta_offsets, build_search_space, match_scan, score_offsets,
    )

    cfg, log, logodds = ctx["cfg"], ctx["log"], ctx["logodds"]
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    gt, ranges = log["gt_poses"], log["ranges"]
    T = len(gt)
    picks = np.linspace(T // 4, T - 10, 4).astype(int) + 3
    nudge = np.array([0.1, -0.08, 0.03], np.float32)
    detail = {}

    # (a) scorers on the frontend's search window around the prior
    S = jax.jit(lambda lo: build_search_space(lo, m, g.resolution))(logodds)
    win = scan_window_cells(g, s, m)
    r = int(round(m.search_xy / g.resolution))
    offs = jnp.arange(-r, r + 1, dtype=jnp.int32)
    dth = jnp.asarray(_theta_offsets(m))

    def scorer(impl, use_bf16):
        @jax.jit
        def f(S, prior, rng):
            Sw, (r0, c0) = extract_window(S, world_to_cell(prior[:2], g), win)
            origin = jnp.stack([g.origin_x + c0 * g.resolution,
                                g.origin_y + r0 * g.resolution])
            pts, valid = scan_endpoints_local(rng, s)
            return score_offsets(Sw, prior, pts, valid, dth, offs, offs,
                                 g.resolution, origin, bilinear=True,
                                 impl=impl, use_bf16=use_bf16)
        return f

    with jax.default_matmul_precision("highest"):
        ref_fn = scorer("gather", False)
        refs = [np.asarray(ref_fn(S, jnp.asarray(gt[t] + nudge),
                                  jnp.asarray(ranges[t]))) for t in picks]
    ok = True
    scorers = {}
    for impl, bf16, tol, precision in SCORERS:
        fn = scorer(impl, bf16)
        err = max(
            float(np.abs(np.asarray(fn(S, jnp.asarray(gt[t] + nudge),
                                       jnp.asarray(ranges[t]))) - ref).max())
            for t, ref in zip(picks, refs)
        )
        key = impl + ("" if bf16 or impl == "gather" else "_f32")
        scorers[key] = {"max_abs_err": err, "tol": tol,
                        "precision": precision}
        ok &= err <= tol
    detail["scorers"] = scorers

    # (b) gather match vs the NumPy reference matcher, both on a map the
    # reference builds itself from ground truth (every 8th scan). Both
    # fields clip at 1 near walls, so each objective has a plateau about a
    # cell wide and the two matchers may pick different points of it: the
    # gate is that our pose is optimal under the REFERENCE's objective
    # (its score there within 0.03 of its best) with theta within one
    # search step; the xy distance between the poses is reported.
    ref = NumpyRefSLAM(size=g.height, resolution=g.resolution,
                       center=(g.center_x, g.center_y), n_beams=s.n_beams,
                       max_range=s.max_range, search_xy=m.search_xy,
                       search_step=g.resolution, search_theta=m.search_theta,
                       theta_step=0.025)
    for t in range(0, T, 8):
        ref.update(gt[t].astype(np.float64), ranges[t].astype(np.float64))
    clean = jnp.asarray(ref.grid)
    S_ref = ref._blur()
    match = jax.jit(lambda lo, rg, pr: match_scan(lo, rg, pr, g, m, s)[0])
    nudge_m = np.array([0.05, -0.04, 0.02], np.float32)
    dxy, dth_err, gap = [], [], []
    for t in picks:
        prior = (gt[t] + nudge_m).astype(np.float32)
        rg = ranges[t].astype(np.float64)
        ours = np.asarray(match(clean, jnp.asarray(ranges[t]),
                                jnp.asarray(prior))).astype(np.float64)
        theirs, best = ref.match(prior.astype(np.float64), rg)
        dxy.append(float(np.hypot(*(ours[:2] - theirs[:2]))))
        dth_err.append(float(abs((ours[2] - theirs[2] + np.pi)
                                 % (2 * np.pi) - np.pi)))
        gap.append(float(best - ref_score(ref, S_ref, ours, rg)))
    detail["match_vs_reference"] = {
        "max_dxy_m": max(dxy), "max_dtheta_rad": max(dth_err),
        "max_ref_score_gap": max(gap), "tol": {"dtheta": 0.025, "gap": 0.03},
    }
    ok &= max(dth_err) <= 0.025 and max(gap) <= 0.03

    # (c) map updates from an empty grid vs the reference's update
    def zeros():
        return jnp.zeros((g.height, g.width), jnp.float32)

    upd = {
        "sparse": jax.jit(lambda p, rg: raycast_update(zeros(), p, rg, g, s)),
        "dense": jax.jit(
            lambda p, rg: raycast_update_dense(zeros(), p, rg, g, s)),
    }
    updates = {}
    for name, fn in upd.items():
        agree, both, ref_touched = 0, 0, 0
        for t in picks:
            ours = np.asarray(fn(jnp.asarray(gt[t], jnp.float32),
                                 jnp.asarray(ranges[t])))
            ref.grid = np.zeros_like(ref.grid)
            ref.update(gt[t].astype(np.float64), ranges[t].astype(np.float64))
            mask = (ours != 0) & (ref.grid != 0)
            both += int(mask.sum())
            ref_touched += int((ref.grid != 0).sum())
            agree += int((np.sign(ours[mask]) == np.sign(ref.grid[mask])).sum())
        frac = agree / max(both, 1)
        updates[name] = {"sign_agreement": frac, "cells_compared": both,
                         "overlap_of_reference": both / max(ref_touched, 1),
                         "tol": 0.99}
        ok &= frac >= 0.99
    detail["updates_vs_reference"] = updates
    return ok, detail


# --- phase 3: FastSLAM -----------------------------------------------------------

def phase_fastslam(ctx):
    import jax
    import jax.numpy as jnp

    from slam2d_tpu.data.synth import simulate_log
    from slam2d_tpu.grid.window import update_window_cells
    from slam2d_tpu.pf.fastslam import _resample_copy
    from slam2d_tpu.pf.shared_update import apply_images
    from slam2d_tpu.run.fastslam_run import run_fastslam

    cfg = pf_cfg()
    log = simulate_log(bench_world(), TOUR[:7], cfg.sensor, step=0.05, seed=0)
    gt = log["gt_poses"]
    a_odom = ate(log["odom"], gt)
    runs, ok = {}, True
    state = None
    for name, P, modes in [
        ("P_small_auto", SIZE["pf_small"], {}),
        ("P_big_auto", SIZE["pf_big"], {}),
        ("P_big_shared", SIZE["pf_big"], {"refine_mode": "shared",
                                          "update_mode": "shared"}),
    ]:
        t0 = time.perf_counter()
        state, traj, n_eff, _ = run_fastslam(log, cfg, pf_params(P, **modes))
        a = ate(traj, gt)
        # This log's odometry is spec-grade (ATE 0.154): at P=1000 the
        # exact filter lands at or just above it (4-seed record 0.162 /
        # 0.164 / 0.166 / 0.173), so its gate is odometry + 0.05; the
        # shared modes quantize map marks to the cell lattice (4-seed
        # mean 0.199 vs per_particle 0.166, single seeds +-0.05), so
        # theirs is the exact run's ATE plus that residual and spread.
        if modes:
            bound = runs["P_big_auto"]["ate_m"] + 0.1
        else:
            bound = a_odom + (0.05 if P == SIZE["pf_big"] else 0.0)
        runs[name] = {"particles": P, "ate_m": a, "bound_m": bound,
                      "min_n_eff": float(np.min(n_eff)),
                      "modes": modes or "auto -> per_particle",
                      "wall_s": time.perf_counter() - t0}
        ok &= a < bound and bool(np.isfinite(traj).all())

    # resample copy of the P=1000 bf16 map stack, and an f32 stack whose
    # values TF32 or bf16 would round, against a host gather
    rng = np.random.default_rng(0)
    copy = jax.jit(_resample_copy)
    maps = state.logodds
    anc = rng.integers(0, maps.shape[0], maps.shape[0]).astype(np.int32)
    exact = bool(np.array_equal(
        np.asarray(copy(maps, jnp.asarray(anc)), np.float32),
        np.asarray(maps, np.float32)[anc]))
    n, gsz = SIZE["copy_rows"], SIZE["pf_grid"]
    f32 = (rng.normal(size=(n, gsz, gsz)) * np.pi).astype(np.float32)
    anc = rng.integers(0, n, n).astype(np.int32)
    exact &= bool(np.array_equal(
        np.asarray(copy(jnp.asarray(f32), jnp.asarray(anc))), f32[anc]))

    # shared-update slot select + windowed add at the big particle count,
    # f32 images
    P = SIZE["pf_big"]
    win = update_window_cells(cfg.grid, cfg.sensor)
    images = (rng.normal(size=(16, win, win)) * np.pi).astype(np.float32)
    slot = rng.integers(0, 16, P).astype(np.int32)
    sel = jax.jit(lambda im, sl: apply_images(
        jnp.zeros((P, gsz, gsz), jnp.float32),
        jnp.full((P, 2), gsz // 2, jnp.int32),
        jnp.take(im, sl, axis=0), win, 1e30))
    out = sel(jnp.asarray(images), jnp.asarray(slot))
    lo = gsz // 2 - win // 2
    select_exact = bool(np.array_equal(
        np.asarray(out[:, lo:lo + win, lo:lo + win]), images[slot]))
    del out
    ok &= exact and select_exact
    ctx.update(pf_log=log)
    return ok, {"impl": "per-particle gather match + sparse update (auto)",
                "odom_ate_m": a_odom, "runs": runs,
                "resample_copy_bit_exact": exact,
                "slot_select_bit_exact": select_exact}


# --- phase 4: localization ----------------------------------------------------

def phase_localize(ctx):
    from slam2d_tpu.match.global_loc import global_localize
    from slam2d_tpu.run.frontend import run_localization

    cfg, log, logodds = ctx["cfg"], ctx["log"], ctx["logodds"]
    _, traj, _, _ = run_localization(log, cfg, np.asarray(logodds))
    a = ate(traj, log["gt_poses"])
    true = np.array([9.0, 7.0, 1.3], np.float32)
    r0 = np.asarray(bench_world().raycast(
        true, np.asarray(cfg.sensor.beam_angles()), cfg.sensor.max_range),
        np.float32)
    est, sc = global_localize(logodds, r0, cfg.grid, cfg.matcher, cfg.sensor)
    est = np.asarray(est)
    err = float(np.hypot(est[0] - true[0], est[1] - true[1]))
    ok = a < ctx["odom_ate"] and err < 0.3 and float(sc) > 0.4
    return ok, {"impl": "gather match on a fixed map; rfft2 sweep",
                "ate_m": a, "odom_ate_m": ctx["odom_ate"],
                "reloc_err_m": err, "reloc_score": float(sc)}


# --- phase 5: full SLAM -----------------------------------------------------------

def phase_full_slam(ctx):
    import dataclasses

    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.data.synth import simulate_log
    from slam2d_tpu.run.full_slam import run_full_slam

    cfg = dataclasses.replace(frontend_cfg(grid=SIZE["fullslam_grid"]),
                              chunk=32,
                              bootstrap_dist=2.0)
    gcfg = GraphConfig(max_nodes=256, max_edges=1024, keyframe_dist=0.8,
                       loop_min_gap=15, loop_radius=3.0,
                       loop_score_accept=0.35, loop_max_correction_xy=2.5,
                       gn_iters=10)
    wp = np.concatenate([TOUR[:6], TOUR[:6][::-1][1:]])   # out and back
    log = simulate_log(bench_world(), wp, cfg.sensor, step=0.15,
                       odom_noise_xy=0.02, odom_noise_theta=0.008, seed=5)
    out, ok = {}, True
    for opt in ("schur", "hier"):
        res = run_full_slam(log, cfg, gcfg, optimizer=opt)
        idx = np.asarray(res.kf_scan_idx, int)
        kf_gt = log["gt_poses"][idx]
        a = ate(res.kf_poses, kf_gt)
        a_odom = ate(log["odom"][idx], kf_gt)
        out[opt] = {"n_loops": int(res.n_loops), "kf_ate_m": a,
                    "odom_kf_ate_m": a_odom}
        ok &= (res.n_loops >= 1 and a < a_odom
               and bool(np.isfinite(res.traj).all()))
    return ok, {"impl": "optimizer", "runs": out}


# --- four cards ------------------------------------------------------------------

def phase_sharded(ctx):
    import jax

    from slam2d_tpu.data.synth import simulate_log
    from slam2d_tpu.run.fastslam_run import run_fastslam
    from slam2d_tpu.run.sharded_run import run_sharded_fastslam

    cfg = pf_cfg()
    log = simulate_log(bench_world(), TOUR[:7], cfg.sensor, step=0.05, seed=0)
    gt = log["gt_poses"]
    a_odom = ate(log["odom"], gt)
    pf = pf_params(SIZE["pf_big"])
    n = len(jax.devices())
    t0 = time.perf_counter()
    state, traj_s, _, _ = run_sharded_fastslam(log, cfg, pf, n_devices=n)
    t_s = time.perf_counter() - t0
    # with the sharded state alive: a path that put every particle on the
    # first card would show it here
    mem = [d.memory_stats() or {} for d in jax.devices()]
    mem = {"bytes_in_use": [m.get("bytes_in_use") for m in mem],
           "peak_bytes_in_use": [m.get("peak_bytes_in_use") for m in mem]}
    del state
    t0 = time.perf_counter()
    _, traj_1, _, _ = run_fastslam(log, cfg, pf)
    t_1 = time.perf_counter() - t0
    a_s, a_1 = ate(traj_s, gt), ate(traj_1, gt)
    bound = a_odom + 0.05          # phase 3's P=1000 bound
    ok = a_s < bound and a_1 < bound and bool(np.isfinite(traj_s).all())
    return ok, {"impl": f"shard_map over {n} cards, ring ppermute resample",
                "ate_sharded_m": a_s, "ate_one_card_m": a_1,
                "odom_ate_m": a_odom, "bound_m": bound,
                "wall_sharded_s": t_s, "wall_one_card_s": t_1,
                "memory_per_card": mem}


def phase_ring_exact(ctx):
    """Force one resample through the sharded step at the big particle
    count and PF map width (bf16, and f32 holding values TF32 would
    round) with skewed weights:
    every map after the ring exchange equals its ancestor's bit for bit."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from slam2d_tpu.parallel.mesh import make_particle_mesh
    from slam2d_tpu.pf.fastslam import systematic_ancestors
    from slam2d_tpu.pf.sharded import (
        make_sharded_step, place_state, sharded_fastslam_init,
    )

    n = len(jax.devices())
    cfg = dataclasses.replace(pf_cfg(), bootstrap_dist=0.0,
                              match_min_motion=0.0,
                              map_update_min_motion=1e9)
    mesh = make_particle_mesh(n)
    out, ok = {}, True
    for dtype in ("bfloat16", "float32"):
        P, gsz = SIZE["pf_big"], SIZE["pf_grid"]
        pf = dataclasses.replace(pf_params(P), map_dtype=dtype,
                                 resample_threshold=2.0)
        rng = np.random.default_rng(1)
        maps = (rng.normal(size=(P, gsz, gsz)) * np.pi).astype(
            np.float32).astype(jnp.dtype(dtype))
        log_w = np.linspace(-9.0, 0.0, P).astype(np.float32)
        state = sharded_fastslam_init(cfg, pf, jax.random.PRNGKey(0), mesh)
        state = place_state(state._replace(
            logodds=maps, log_w=log_w, since_update=np.float32(0.0)), mesh)
        key = state.rng
        step = jax.jit(make_sharded_step(cfg, pf, mesh, ring_stats=True))
        # no-hit scan: every particle scores 0, weights keep their order
        new, (_, _, _, k_need) = step(
            state, jnp.zeros(3, jnp.float32),
            jnp.full((cfg.sensor.n_beams,), 100.0, jnp.float32))
        u = jax.random.uniform(
            jax.random.fold_in(jax.random.split(key)[1], 10_000_019))
        anc = np.asarray(systematic_ancestors(jnp.asarray(log_w), u))
        exact = bool(np.array_equal(np.asarray(new.logodds), maps[anc]))
        out[dtype] = {"bit_exact": exact,
                      "max_ring_distance": int(np.asarray(k_need).max())}
        ok &= exact and int(np.asarray(k_need).max()) >= 1
        del new, state
    return ok, {"impl": "ring ppermute + row gather", **out}


def phase_dryrun(ctx):
    import jax

    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    n = len(jax.devices())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(n)
    return True, {"impl": f"dryrun_multichip({n})"}


# --- profile -------------------------------------------------------------------------

def median_ms(fn, *args, reps=10):
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def stage_times(ctx):
    """Each stage as its own jitted program at full width, timed on the
    host clock around block_until_ready (median of 10)."""
    import jax
    import jax.numpy as jnp

    from slam2d_tpu.grid.occupancy import integrate_scan, world_to_cell
    from slam2d_tpu.grid.window import (
        extract_window, scan_window_cells, update_window_cells,
    )
    from slam2d_tpu.match.correlative import build_search_space, match_scan
    from slam2d_tpu.pf.fastslam import (
        _refine_all, _resample_copy, _update_all, effective_sample_size,
        systematic_ancestors,
    )

    cfg, log, lo = ctx["cfg"], ctx["log"], ctx["logodds"]
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    t = len(log["odom"]) // 2
    pose = jnp.asarray(log["gt_poses"][t], jnp.float32)
    rg = jnp.asarray(log["ranges"][t])
    win = scan_window_cells(g, s, m)
    uwin = update_window_cells(g, s)

    def rebuild(lo, pose):
        gw, _ = extract_window(lo, world_to_cell(pose[:2], g), win)
        return build_search_space(gw, m, g.resolution)

    def match(lo, pose, rg):
        gw, (r0, c0) = extract_window(lo, world_to_cell(pose[:2], g), win)
        Sw = build_search_space(gw, m, g.resolution)
        origin = (g.origin_x + c0 * g.resolution,
                  g.origin_y + r0 * g.resolution)
        return match_scan(lo, rg, pose, g, m, s, search_space=Sw,
                          origin_xy=origin)

    def update(lo, pose, rg):
        gw, orc = extract_window(lo, world_to_cell(pose[:2], g), uwin)
        return integrate_scan(gw, pose, rg, g, s, origin_rc=jnp.stack(orc))

    out = {f"frontend_{g.height}": {
        "search_space_rebuild_ms": median_ms(jax.jit(rebuild), lo, pose),
        "match_incl_rebuild_ms": median_ms(jax.jit(match), lo, pose, rg),
        "map_update_ms": median_ms(jax.jit(update), lo, pose, rg),
    }}

    pcfg = pf_cfg()
    pf = pf_params(SIZE["pf_big"])
    P = pf.n_particles
    gsz = SIZE["pf_grid"]
    maps = jnp.zeros((P, gsz, gsz), jnp.bfloat16)
    plog = ctx["pf_log"]
    t = len(plog["odom"]) // 2
    prg = jnp.asarray(plog["ranges"][t])
    priors = jnp.asarray(plog["gt_poses"][t], jnp.float32) + jax.random.normal(
        jax.random.PRNGKey(0), (P, 3)) * 0.02
    # a realistic map under every particle: integrate a few scans first
    maps = jax.jit(lambda mp, p, r: _update_all(mp, p, r, pcfg, pf))(
        maps, priors, prg)

    def weight(log_w, scores):
        lw = log_w + pf.weight_sharpness * scores
        lw = lw - jax.scipy.special.logsumexp(lw)
        return lw, effective_sample_size(lw)

    def resample(mp, lw, u):
        return _resample_copy(mp, systematic_ancestors(lw, u))

    lw = jnp.linspace(-3.0, 0.0, P)
    out[f"fastslam_{P}"] = {
        "refine_ms": median_ms(jax.jit(
            lambda mp, pr, r: _refine_all(mp, r, pr, pcfg, pf)),
            maps, priors, prg),
        "weight_ms": median_ms(jax.jit(weight), lw, jnp.zeros(P)),
        "update_ms": median_ms(jax.jit(
            lambda mp, p, r: _update_all(mp, p, r, pcfg, pf)),
            maps, priors, prg),
        "resample_ms": median_ms(jax.jit(resample), maps, lw,
                                 jnp.float32(0.3)),
    }
    return out


def phase_profile(ctx, logdir):
    """Warm (already compiled) runs of the frontend and the big-P FastSLAM
    under the profiler, each reduced to device busy/idle and top kernels,
    plus the per-stage times."""
    from slam2d_tpu.run.fastslam_run import run_fastslam
    from slam2d_tpu.run.frontend import run_frontend
    from slam2d_tpu.utils.profiling import device_time_summary, trace

    out = {}
    runs = {
        "frontend": lambda: run_frontend(ctx["log"], ctx["cfg"]),
        "fastslam": lambda: run_fastslam(ctx["pf_log"], pf_cfg(),
                                         pf_params(SIZE["pf_big"])),
    }
    for name, fn in runs.items():
        path = os.path.join(logdir, name)
        t0 = time.perf_counter()
        with trace(path):
            fn()
        out[name] = {"traced_wall_s": time.perf_counter() - t0,
                     "devices": device_time_summary(path)}
    out["stages"] = stage_times(ctx)
    return True, out


# --- main ------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the sharded paths over four cards")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the frontend and FastSLAM phases into DIR "
                         "and time each stage")
    args = ap.parse_args(argv)

    import jax

    from slam2d_tpu.device import describe, require_gpu, setup_compile_cache

    device = None
    try:
        require_gpu()
        info = describe()
        device = {k: info[k] for k in ("platform", "kind", "count")}
        if info["count"] < args.cards:
            raise RuntimeError(f"--cards {args.cards} but JAX sees "
                               f"{info['count']} device(s)")
    except RuntimeError as e:
        emit({"ok": False, "error": str(e), "device": device})
        return 1
    cache = setup_compile_cache()
    for card in info["cards"]:
        print(f"{card['name']}, {card['power_limit']}", flush=True)
    emit({"jax": jax.__version__, "compile_cache": cache, "device": info})

    phases, ctx = Phases(), {}
    if args.cards == 4:
        phases.run("sharded_fastslam", lambda: phase_sharded(ctx))
        phases.run("ring_exchange_exact", lambda: phase_ring_exact(ctx))
        phases.run("dryrun_multichip", lambda: phase_dryrun(ctx))
    else:
        phases.run("frontend", lambda: phase_frontend(ctx))
        phases.run("parity", lambda: phase_parity(ctx))
        phases.run("fastslam", lambda: phase_fastslam(ctx))
        phases.run("localize", lambda: phase_localize(ctx))
        phases.run("full_slam", lambda: phase_full_slam(ctx))
        if args.profile:
            phases.run("profile", lambda: phase_profile(ctx, args.profile))
    emit({"ok": phases.ok, "device": device})
    return 0 if phases.ok else 1


if __name__ == "__main__":
    sys.exit(main())
