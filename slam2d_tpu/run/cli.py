"""Command-line driver (SURVEY.md §2 L5: `slam/run/` CLI + config overrides).

Replaces the reference's hard-coded `main.py` scripts with one entry point:

    python -m slam2d_tpu.run.cli --mode frontend --log intel.json --out out/
    python -m slam2d_tpu.run.cli --mode fastslam --log synth --particles 64
    python -m slam2d_tpu.run.cli --mode full --log aces.clf --gt-ate

Log inputs: a CARMEN file (*.log/*.clf), a preprocessed JSON log, or the
literal `synth` for the built-in synthetic world. Outputs: trajectory .npy,
map .npy and .png, metrics printed as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="slam2d_tpu", description=__doc__)
    p.add_argument("--mode",
                   choices=["frontend", "fastslam", "full", "localize"],
                   default="frontend")
    p.add_argument("--tiled", action="store_true",
                   help="unbounded tiled world map (frontend/full modes)")
    p.add_argument("--tile-size", type=int, default=512)
    p.add_argument("--tile-slots", type=int, default=64)
    p.add_argument("--schur", action="store_true",
                   help="block-Schur pose-graph optimizer (full mode)")
    p.add_argument("--optimizer", default=None,
                   choices=["auto", "dense", "schur", "schur_sharded",
                            "sparse", "hier"],
                   help="pose-graph optimizer (full mode): auto (dense to "
                        "~1k keyframes, hierarchical beyond — the f32 "
                        "collapse boundary), dense Cholesky, "
                        "block-Schur, mesh-sharded block-Schur over all "
                        "visible devices, matrix-free two-level PCG "
                        "(no dense H — large graphs), or hierarchical "
                        "anchor-graph + PCG polish (largest graphs); "
                        "overrides --schur")
    p.add_argument("--log", required=True,
                   help="CARMEN .log/.clf, preprocessed .json, or 'synth'")
    p.add_argument("--map", default=None,
                   help="localize mode: prebuilt map — a ROS map_server "
                        ".yaml (with its .pgm) or a map_logodds.npy")
    p.add_argument("--recover", action="store_true",
                   help="localize mode: when tracking scores collapse, "
                        "relocalize on the whole map and reset the pose")
    p.add_argument("--global-init", action="store_true",
                   help="localize mode: recover the starting pose from the "
                        "first scan by whole-map FFT relocalization "
                        "(kidnapped-robot start; ignores the odometry "
                        "frame's origin)")
    p.add_argument("--out", default=None, help="output directory")
    # grid overrides
    p.add_argument("--grid-size", type=int, default=1024)
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--center", type=float, nargs=2, default=None,
                   metavar=("X", "Y"),
                   help="world center of the grid (default: odometry centroid)")
    # sensor overrides
    p.add_argument("--beams", type=int, default=None)
    p.add_argument("--max-range", type=float, default=12.0)
    # matcher overrides
    p.add_argument("--search-xy", type=float, default=0.3)
    p.add_argument("--search-theta", type=float, default=0.15)
    p.add_argument("--n-theta", type=int, default=13)
    # kernel overrides ("auto" = the plain XLA paths on every backend)
    p.add_argument("--score-impl", default="auto",
                   choices=["auto", "gather", "mxu", "mxu_int8", "emx"],
                   help="candidate-scoring kernel (auto: gather; the "
                        "others are one-hot-matmul formulations)")
    p.add_argument("--update-impl", default="auto",
                   choices=["auto", "sparse", "sparse_mxu", "dense"],
                   help="scan-integration kernel (auto: sparse — sampled "
                        "rays with scatter-add accumulation)")
    # pf
    p.add_argument("--particles", type=int, default=32)
    p.add_argument("--shard", action="store_true",
                   help="shard particles over all visible devices")
    p.add_argument("--map-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="per-particle map storage dtype (fastslam mode)")
    p.add_argument("--refine-mode", default="auto",
                   choices=["auto", "shared", "per_particle"],
                   help="PF refinement batching: one shared-stack "
                        "matmul for all particles, or a vmapped "
                        "per-particle matcher (auto: per_particle)")
    p.add_argument("--refine-chunk", type=int, default=0,
                   help="process per-particle refinement/update in chunks "
                        "of this size (bounds device memory at 1000+ "
                        "particles)")
    p.add_argument("--update-mode", default="auto",
                   choices=["auto", "shared", "per_particle"],
                   help="PF map-update batching: G shared theta-slot "
                        "images added per particle (lattice-quantized "
                        "marks), or exact per-particle updates (auto: "
                        "per_particle)")
    p.add_argument("--update-qstep-cells", type=float, default=0.5,
                   help="shared-update rotation quantization target: max "
                        "endpoint displacement in cells at max range "
                        "(PFConfig.update_qstep_cells; halving it wants "
                        "--update-theta-slots doubled for coverage)")
    p.add_argument("--update-theta-slots", type=int, default=16,
                   help="shared-update global theta slots (coverage, not "
                        "resolution — see PFConfig)")
    p.add_argument("--pf-noise-xy", type=float, default=None,
                   help="PF proposal noise sigma, m/step (default: "
                        "PFConfig's; match to the log's odometry spec)")
    p.add_argument("--pf-noise-theta", type=float, default=None,
                   help="PF proposal heading noise sigma, rad/step")
    # misc
    # pose-graph / loop-closure gates (full mode; None = GraphConfig default)
    p.add_argument("--keyframe-dist", type=float, default=None,
                   help="admit a keyframe every d meters")
    p.add_argument("--max-nodes", type=int, default=None,
                   help="keyframe capacity of the pose graph")
    p.add_argument("--loop-radius", type=float, default=None,
                   help="spatial gate (m) for loop candidates")
    p.add_argument("--loop-accept", type=float, default=None,
                   help="matcher score to accept a loop edge")
    p.add_argument("--loop-max-correction", type=float, default=None,
                   help="max |xy| correction (m) an accepted loop may imply "
                        "(plausibility gate; raise for long-drift logs)")
    p.add_argument("--robust", default=None,
                   choices=["none", "huber", "dcs"],
                   help="robust kernel on pose-graph edges (full mode): a "
                        "false-positive loop edge fails soft instead of "
                        "corrupting the trajectory (dcs recommended; GNC-"
                        "annealed over the first iterations)")
    p.add_argument("--robust-delta", type=float, default=None,
                   help="robust kernel threshold in whitened-residual units")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gt-ate", action="store_true",
                   help="print ATE vs ground truth (synth logs only)")
    p.add_argument("--relations", default=None, metavar="FILE",
                   help="score the trajectory against a Radish relations "
                        "file (t1 t2 x y z roll pitch yaw — the CARMEN "
                        "benchmark ground-truth format; needs a log with "
                        "timestamps, i.e. a real .clf)")
    p.add_argument("--save-viz", action="store_true")
    p.add_argument("--save-video", default=None, metavar="PATH",
                   help="write a map-build animation (.gif, or .mp4 via "
                        "OpenCV) captured at chunk boundaries "
                        "(frontend/fastslam/full non-tiled modes; costs "
                        "one map fetch per chunk)")
    p.add_argument("--video-every", type=int, default=1,
                   help="keep every Nth chunk-boundary frame")
    p.add_argument("--video-fps", type=int, default=10)
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars under OUT/tb "
                        "(needs tensorboardX; silently skipped otherwise)")
    # checkpoint/resume (frontend/fastslam/full modes): [start, end) scans
    p.add_argument("--save-state", default=None,
                   help="directory to save the pipeline state (.npz)")
    p.add_argument("--resume-state", default=None,
                   help="directory to restore the pipeline state from")
    p.add_argument("--scan-range", type=int, nargs=2, default=None,
                   metavar=("START", "END"),
                   help="process only scans [START, END) — pair with "
                        "--save-state/--resume-state for mid-log resume")
    return p


def _median_score(scores) -> float:
    """Median of MATCHED scores; -1.0 when no scan ever matched (a NaN
    here would make the metrics line invalid JSON)."""
    m = np.asarray(scores)
    m = m[m >= 0.0]
    return float(np.median(m)) if len(m) else -1.0


def load_any_log(path: str, sensor_cfg):
    from slam2d_tpu.data import load_carmen_log, load_json_log
    from slam2d_tpu.data.synth import default_log

    if path == "synth":
        _, log = default_log(sensor_cfg, step=0.05)
        return log
    if path.endswith(".json"):
        return load_json_log(path)
    return load_carmen_log(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from slam2d_tpu.device import setup_compile_cache

    setup_compile_cache()

    from slam2d_tpu.config import (
        FrontendConfig, GraphConfig, GridConfig, MatcherConfig, PFConfig,
        SensorConfig,
    )

    sensor = SensorConfig(
        n_beams=args.beams or 180, max_range=args.max_range
    )
    log = load_any_log(args.log, sensor)
    if args.beams is None and log["ranges"].shape[1] != sensor.n_beams:
        sensor = dataclasses.replace(sensor, n_beams=log["ranges"].shape[1])

    # Default grid anchor: odometry centroid keeps the whole (drifting)
    # trajectory plus sensor range inside the fixed-capacity grid.
    cx, cy = (
        args.center if args.center is not None else log["odom"][:, :2].mean(axis=0)
    )
    cfg = FrontendConfig(
        sensor=sensor,
        grid=GridConfig(
            height=args.grid_size, width=args.grid_size,
            resolution=args.resolution,
            ray_samples=int(args.max_range / args.resolution) + 16,
            center_x=float(cx), center_y=float(cy),
            update_impl=args.update_impl,
        ),
        matcher=MatcherConfig(
            search_xy=args.search_xy, search_theta=args.search_theta,
            n_theta=args.n_theta, score_impl=args.score_impl,
        ),
        chunk=args.chunk,
    )

    if args.scan_range is not None:
        s0, s1 = args.scan_range
        log = {k: v[s0:s1] for k, v in log.items()}

    def tile_cfg():
        from slam2d_tpu.grid.tiles import TileConfig

        return TileConfig(
            tile=args.tile_size, n_slots=args.tile_slots,
            resolution=args.resolution,
        )

    recorder = None
    if args.save_video:
        if args.tiled or (args.mode == "fastslam" and args.shard):
            raise SystemExit(
                "--save-video supports frontend/fastslam/full non-tiled, "
                "non-sharded runs"
            )
        from slam2d_tpu.viz.video import VideoRecorder

        recorder = VideoRecorder(
            args.save_video, cfg.grid, fps=args.video_fps,
            every=args.video_every,
        )
        if "gt_poses" in log:
            recorder.set_ground_truth(log["gt_poses"])

    t0 = time.perf_counter()
    extra: dict = {}
    if args.mode == "frontend" and args.tiled:
        from slam2d_tpu.run.frontend_tiled import run_tiled_frontend

        state, traj, scores = run_tiled_frontend(log, cfg, tile_cfg())
        grid = state.grid.tiles
        tiled_grid = state.grid
        extra["median_score"] = _median_score(scores)
        extra["tiled"] = True
    elif args.mode == "localize":
        import dataclasses as _dc

        from slam2d_tpu.run.frontend import run_localization

        if not args.map:
            raise SystemExit("--mode localize requires --map")
        if args.map.endswith(".npy"):
            prebuilt = np.load(args.map)
            sidecar = os.path.join(os.path.dirname(args.map), "grid.json")
            if os.path.exists(sidecar):
                # geometry the map was BUILT with (see the --out writer):
                # without it the grid would anchor at the new log's
                # odometry centroid and every cell would be misregistered
                with open(sidecar) as f:
                    gj = json.load(f)
                cfg = dataclasses.replace(
                    cfg, grid=dataclasses.replace(cfg.grid, **gj)
                )
            elif args.center is None:
                raise SystemExit(
                    "--map *.npy without a grid.json sidecar: pass the "
                    "--center/--resolution/--grid-size the map was built "
                    "with (or localize against the map.yaml instead)"
                )
            gcfg = cfg.grid
            if prebuilt.shape != (gcfg.height, gcfg.width):
                raise SystemExit(
                    f"map shape {prebuilt.shape} != grid "
                    f"{(gcfg.height, gcfg.width)}; pass matching --grid-size"
                )
        else:
            from slam2d_tpu.viz.ros_map import load_ros_map

            prebuilt, gcfg = load_ros_map(args.map)
            cfg = _dc.replace(cfg, grid=gcfg)
        start = None
        if args.global_init:
            from slam2d_tpu.match.global_loc import global_localize

            p0, sc0 = global_localize(
                prebuilt, np.asarray(log["ranges"][0], np.float32),
                cfg.grid, cfg.matcher, cfg.sensor,
            )
            start = np.asarray(p0)
            extra["global_init_pose"] = [round(float(v), 4) for v in start]
            extra["global_init_score"] = round(float(sc0), 4)
        state, traj, scores, events = run_localization(
            log, cfg, prebuilt, start_pose=start, recover=args.recover,
        )
        if events:
            extra["recoveries"] = events
        grid = state.logodds
        extra["median_score"] = _median_score(scores)
        extra["localized_against"] = args.map
    elif args.mode == "frontend":
        from slam2d_tpu.run.frontend import frontend_init, run_frontend

        init_state = None
        if args.resume_state:
            from slam2d_tpu.utils.checkpoint import load_state

            init_state = load_state(args.resume_state, frontend_init(cfg))
            extra["resumed_from"] = args.resume_state
        state, traj, scores = run_frontend(
            log, cfg, state=init_state,
            frame_cb=recorder.add if recorder else None,
        )
        if args.save_state:
            from slam2d_tpu.utils.checkpoint import save_state

            save_state(args.save_state, state)
            extra["saved_state"] = args.save_state
        grid = state.logodds
        extra["median_score"] = _median_score(scores)
    elif args.mode == "fastslam":
        from slam2d_tpu.config import PFConfig
        from slam2d_tpu.run.fastslam_run import run_fastslam

        pf_noise = {}
        if args.pf_noise_xy is not None:
            pf_noise["noise_xy"] = args.pf_noise_xy
        if args.pf_noise_theta is not None:
            pf_noise["noise_theta"] = args.pf_noise_theta
        pf = PFConfig(
            n_particles=args.particles, map_dtype=args.map_dtype,
            refine_chunk=args.refine_chunk, refine_mode=args.refine_mode,
            update_mode=args.update_mode,
            update_theta_slots=args.update_theta_slots,
            update_qstep_cells=args.update_qstep_cells, **pf_noise,
        )
        init_state = None
        if args.resume_state:
            from slam2d_tpu.pf.fastslam import pf_state_template
            from slam2d_tpu.utils.checkpoint import load_state

            init_state = load_state(
                args.resume_state, pf_state_template(cfg, pf)
            )
            extra["resumed_from"] = args.resume_state
        if args.shard:
            from slam2d_tpu.run.sharded_run import run_sharded_fastslam

            state, traj, n_eff, scores = run_sharded_fastslam(
                log, cfg, pf, seed=args.seed, state=init_state
            )
        else:
            state, traj, n_eff, scores = run_fastslam(
                log, cfg, pf, seed=args.seed, state=init_state,
                frame_cb=recorder.add if recorder else None,
            )
        if args.save_state:
            from slam2d_tpu.utils.checkpoint import save_state

            save_state(args.save_state, state)
            extra["saved_state"] = args.save_state
        best = int(np.argmax(np.asarray(state.log_w)))
        grid = state.logodds[best]
        extra["mean_n_eff"] = float(np.mean(n_eff))
    else:  # full
        overrides = {
            k: v
            for k, v in {
                "keyframe_dist": args.keyframe_dist,
                "max_nodes": args.max_nodes,
                "loop_radius": args.loop_radius,
                "loop_score_accept": args.loop_accept,
                "loop_max_correction_xy": args.loop_max_correction,
                "robust_kind": args.robust,
                "robust_delta": args.robust_delta,
            }.items()
            if v is not None
        }
        gcfg = GraphConfig(**overrides)
        optimizer = args.optimizer or ("schur" if args.schur else "auto")
        if args.tiled:
            from slam2d_tpu.run.full_slam_tiled import (
                fullslam_tiled_ckpt_template, run_full_slam_tiled,
            )

            resume = None
            if args.resume_state:
                from slam2d_tpu.utils.checkpoint import load_state

                resume = load_state(
                    args.resume_state,
                    fullslam_tiled_ckpt_template(cfg, tile_cfg(), gcfg),
                )
                extra["resumed_from"] = args.resume_state
            offset = args.scan_range[0] if args.scan_range else 0
            res = run_full_slam_tiled(
                log, cfg, tile_cfg(), gcfg, optimizer=optimizer,
                resume=resume, scan_index_offset=offset,
            )
            if args.save_state:
                from slam2d_tpu.utils.checkpoint import save_state

                save_state(args.save_state, res.ckpt)
                extra["saved_state"] = args.save_state
            extra["tiled"] = True
        else:
            from slam2d_tpu.run.full_slam import (
                fullslam_ckpt_template, run_full_slam,
            )

            resume = None
            if args.resume_state:
                from slam2d_tpu.utils.checkpoint import load_state

                resume = load_state(
                    args.resume_state, fullslam_ckpt_template(cfg, gcfg)
                )
                extra["resumed_from"] = args.resume_state
            offset = args.scan_range[0] if args.scan_range else 0
            res = run_full_slam(
                log, cfg, gcfg, optimizer=optimizer, resume=resume,
                scan_index_offset=offset,
                frame_cb=recorder.add if recorder else None,
            )
            if args.save_state:
                from slam2d_tpu.utils.checkpoint import save_state

                save_state(args.save_state, res.ckpt)
                extra["saved_state"] = args.save_state
        traj, grid = res.traj, res.grid
        if args.tiled:
            tiled_grid = res.grid
            grid = res.grid.tiles   # [N, th, tw] slot pool for .npy export
        extra["n_loops"] = res.n_loops
        extra["n_keyframes"] = len(res.kf_poses)
        extra["chi2"] = res.chi2
    dt = time.perf_counter() - t0
    if recorder is not None and recorder.frames:
        extra["video"] = recorder.save()
        extra["video_frames"] = len(recorder.frames)

    metrics = {
        "mode": args.mode,
        "scans": len(traj),
        "wall_s": round(dt, 3),
        "scans_per_sec": round(len(traj) / dt, 2),
        **extra,
    }
    if args.gt_ate and "gt_poses" in log:
        from slam2d_tpu.metrics import ate_rmse

        metrics["ate_m"] = round(ate_rmse(traj, log["gt_poses"], align=False), 4)
        metrics["ate_odom_m"] = round(
            ate_rmse(log["odom"], log["gt_poses"], align=False), 4
        )
    if args.relations:
        # Radish relations-file scoring (the CARMEN benchmark ground
        # truth: verified relative poses keyed by scan timestamp)
        from slam2d_tpu.metrics import load_relations, rpe_relations

        if "stamps" not in log:
            metrics["relations_error"] = "log has no timestamps"
        else:
            rr = rpe_relations(
                traj[: len(log["stamps"])], log["stamps"][: len(traj)],
                load_relations(args.relations),
            )
            metrics["relations_trans_rmse_m"] = round(rr["trans_rmse"], 4)
            metrics["relations_rot_rmse_rad"] = round(rr["rot_rmse"], 4)
            metrics["relations_used"] = rr["n_used"]
            metrics["relations_total"] = rr["n_total"]

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, "trajectory.npy"), traj)
        np.save(os.path.join(args.out, "map_logodds.npy"), np.asarray(grid))
        # grid geometry sidecar: a later `--mode localize --map
        # map_logodds.npy` must interpret the cells at the SAME world
        # coordinates the map was built with (the CLI otherwise anchors
        # the grid at the NEW log's odometry centroid)
        gj = {
            "height": cfg.grid.height, "width": cfg.grid.width,
            "resolution": cfg.grid.resolution,
            "center_x": cfg.grid.center_x, "center_y": cfg.grid.center_y,
        }
        with open(os.path.join(args.out, "grid.json"), "w") as f:
            json.dump(gj, f)
        # ROS map_server interchange (PGM + YAML): lets rviz / map_server /
        # AMCL consume the built map directly
        if np.asarray(grid).ndim == 2:
            from slam2d_tpu.viz.ros_map import save_ros_map

            save_ros_map(os.path.join(args.out, "map"), grid, cfg.grid)
        elif args.tiled:
            from slam2d_tpu.viz.ros_map import save_tiled_ros_map

            save_tiled_ros_map(
                os.path.join(args.out, "map"), tiled_grid, tile_cfg()
            )
        if args.save_viz and np.asarray(grid).ndim == 2:
            from slam2d_tpu.viz import save_map_png

            save_map_png(
                os.path.join(args.out, "map.png"), grid, cfg.grid,
                traj=traj, gt=log.get("gt_poses"),
                title=f"{args.mode} | {os.path.basename(args.log)}",
            )
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        from slam2d_tpu.utils.metrics_logger import MetricsLogger

        with MetricsLogger(args.out, tensorboard=args.tensorboard) as ml:
            ml.log(0, **{k: v for k, v in metrics.items()
                         if isinstance(v, (int, float))})

    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
