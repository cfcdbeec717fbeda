"""Checkpoint/resume mid-log: split run == single run (frontend)."""

import numpy as np

from slam2d_tpu.config import FrontendConfig, GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.run.frontend import frontend_init, run_frontend
from slam2d_tpu.utils.checkpoint import load_state, save_state


def test_split_run_matches_single_run(tmp_path):
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=60, max_range=10.0),
        grid=GridConfig(height=192, width=192, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=8,
        bootstrap_dist=1.0,
    )
    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 7.0], [7.0, 7.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.2, seed=4)
    T = len(log["odom"])
    cut = (T // 2 // cfg.chunk) * cfg.chunk  # chunk-aligned split

    # single run
    _, traj_full, _ = run_frontend(log, cfg)

    # split run with checkpoint in the middle
    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    state, traj_a, _ = run_frontend(first, cfg)
    path = save_state(str(tmp_path / "ck"), state)
    restored = load_state(path, frontend_init(cfg))
    _, traj_b, _ = run_frontend(second, cfg, state=restored)

    traj_split = np.concatenate([traj_a, traj_b])
    np.testing.assert_allclose(traj_split, traj_full, atol=1e-4)


def test_full_slam_split_run_matches_single_run(tmp_path):
    """Full SLAM (config 5) checkpoint/resume: keyframes, graph, and loop
    closures of a split run match the single run; part-2 trajectory rows
    agree (part-1 rows emitted before the split can't be retro-corrected
    by loops closed after it — documented semantic of mid-log resume)."""
    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.run.full_slam import fullslam_ckpt_template, run_full_slam

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=120, max_range=12.0),
        grid=GridConfig(
            height=256, width=256, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=16,
        bootstrap_dist=2.0,
    )
    gcfg = GraphConfig(
        max_nodes=128, max_edges=512, keyframe_dist=0.5,
        loop_min_gap=10, loop_radius=2.5, loop_score_accept=0.35,
        gn_iters=10,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0],
         [3.0, 3.8]]
    )
    log = simulate_log(
        world, wp, cfg.sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.008, seed=5,
    )
    T = len(log["odom"])
    cut = (T // 2 // cfg.chunk) * cfg.chunk

    full = run_full_slam(log, cfg, gcfg)
    assert full.n_loops >= 1  # the scenario must exercise loop closure

    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    res_a = run_full_slam(first, cfg, gcfg)
    path = save_state(str(tmp_path / "fs_ck"), res_a.ckpt)
    restored = load_state(path, fullslam_ckpt_template(cfg, gcfg))
    res_b = run_full_slam(
        second, cfg, gcfg, resume=restored, scan_index_offset=cut
    )

    assert res_b.n_loops == full.n_loops
    np.testing.assert_array_equal(res_b.kf_scan_idx, full.kf_scan_idx)
    np.testing.assert_allclose(res_b.kf_poses, full.kf_poses, atol=1e-3)
    np.testing.assert_allclose(res_b.traj, full.traj[cut:], atol=1e-3)


def test_tiled_full_slam_split_run_matches_single_run(tmp_path):
    """Tiled (unbounded-world) full SLAM resumes mid-log: restored tile
    pool + slot table + graph reproduce the single run's keyframes and
    post-split trajectory."""
    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.grid.tiles import TileConfig
    from slam2d_tpu.run.full_slam_tiled import (
        fullslam_tiled_ckpt_template,
        run_full_slam_tiled,
    )

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=120, max_range=12.0),
        grid=GridConfig(resolution=0.1, ray_samples=128),  # params only
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=16,
        bootstrap_dist=2.0,
    )
    tcfg = TileConfig(tile=128, n_slots=32, resolution=0.1)
    gcfg = GraphConfig(
        max_nodes=128, max_edges=512, keyframe_dist=0.5,
        loop_min_gap=10, loop_radius=2.5, loop_score_accept=0.35,
        gn_iters=10,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0],
         [3.0, 3.8]]
    )
    log = simulate_log(
        world, wp, cfg.sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.008, seed=5,
    )
    T = len(log["odom"])
    cut = (T // 2 // cfg.chunk) * cfg.chunk

    full = run_full_slam_tiled(log, cfg, tcfg, gcfg)
    assert full.n_loops >= 1

    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    res_a = run_full_slam_tiled(first, cfg, tcfg, gcfg)
    path = save_state(str(tmp_path / "fst_ck"), res_a.ckpt)
    restored = load_state(path, fullslam_tiled_ckpt_template(cfg, tcfg, gcfg))
    res_b = run_full_slam_tiled(
        second, cfg, tcfg, gcfg, resume=restored, scan_index_offset=cut
    )

    assert res_b.n_loops == full.n_loops
    np.testing.assert_array_equal(res_b.kf_scan_idx, full.kf_scan_idx)
    np.testing.assert_allclose(res_b.kf_poses, full.kf_poses, atol=1e-3)
    np.testing.assert_allclose(res_b.traj, full.traj[cut:], atol=1e-3)


def test_fastslam_split_run_matches_single_run(tmp_path):
    """FastSLAM (config 3) checkpoint/resume: PFState (particle poses,
    per-particle maps, log-weights, RNG) round-trips through the npz
    checkpoint and a split run reproduces the single run exactly — the
    RNG key rides in the state, so proposal noise and resampling draws
    are identical."""
    from slam2d_tpu.config import PFConfig
    from slam2d_tpu.pf.fastslam import pf_state_template
    from slam2d_tpu.run.fastslam_run import run_fastslam

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=60, max_range=10.0),
        grid=GridConfig(height=160, width=160, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=7),
        chunk=8,
    )
    pf = PFConfig(n_particles=8, refine_mode="per_particle")
    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 7.0], [7.0, 7.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.2, seed=4)
    T = len(log["odom"])
    cut = (T // 2 // cfg.chunk) * cfg.chunk

    _, traj_full, neff_full, _ = run_fastslam(log, cfg, pf, seed=1)

    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    state, traj_a, neff_a, _ = run_fastslam(first, cfg, pf, seed=1)
    path = save_state(str(tmp_path / "pf_ck"), state)
    restored = load_state(path, pf_state_template(cfg, pf))
    _, traj_b, neff_b, _ = run_fastslam(second, cfg, pf, state=restored)

    np.testing.assert_allclose(
        np.concatenate([traj_a, traj_b]), traj_full, atol=1e-4
    )
    np.testing.assert_allclose(
        np.concatenate([neff_a, neff_b]), neff_full, atol=1e-3
    )


def test_sharded_fastslam_resume_restores_placement(tmp_path):
    """Sharded FastSLAM resume: the restored PFState is re-placed onto the
    particle mesh (sharded leaves) and the split run matches the single
    run — checkpoint format is mesh-independent host arrays."""
    from slam2d_tpu.config import PFConfig
    from slam2d_tpu.pf.fastslam import pf_state_template
    from slam2d_tpu.run.sharded_run import run_sharded_fastslam

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=60, max_range=10.0),
        grid=GridConfig(height=160, width=160, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=7),
        chunk=8,
    )
    pf = PFConfig(n_particles=16, refine_mode="per_particle")
    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 7.0], [7.0, 7.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.25, seed=4)
    T = len(log["odom"])
    cut = (T // 2 // cfg.chunk) * cfg.chunk

    _, traj_full, _, _ = run_sharded_fastslam(log, cfg, pf, seed=1)

    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    state, traj_a, _, _ = run_sharded_fastslam(first, cfg, pf, seed=1)
    path = save_state(str(tmp_path / "spf_ck"), state)
    restored = load_state(path, pf_state_template(cfg, pf))
    _, traj_b, _, _ = run_sharded_fastslam(
        second, cfg, pf, state=restored
    )
    np.testing.assert_allclose(
        np.concatenate([traj_a, traj_b]), traj_full, atol=1e-4
    )
