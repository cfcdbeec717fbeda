"""ATE parity: our frontend vs the NumPy reference-style comparator on the
same synthetic log (SURVEY.md §6 "Parity tests vs reference behavior")."""

import numpy as np

from slam2d_tpu.config import FrontendConfig, GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run.frontend import run_frontend

from tests.numpy_reference import NumpyRefSLAM


def test_frontend_ate_parity_with_numpy_reference():
    sensor = SensorConfig(n_beams=120, max_range=12.0)
    cfg = FrontendConfig(
        sensor=sensor,
        grid=GridConfig(
            height=256, width=256, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=16,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5]])
    log = simulate_log(
        world, wp, sensor, step=0.15,
        odom_noise_xy=0.015, odom_noise_theta=0.006, seed=13,
    )

    _, traj_ours, _ = run_frontend(log, cfg)
    ref = NumpyRefSLAM(n_beams=sensor.n_beams)
    traj_ref = ref.run(log, bootstrap=20)

    gt = log["gt_poses"]
    ate_ours = ate_rmse(traj_ours, gt, align=False)
    ate_ref = ate_rmse(traj_ref, gt, align=False)
    ate_odom = ate_rmse(log["odom"], gt, align=False)

    # the comparator must be functional (improves on or tracks odometry)
    assert ate_ref < max(2.0 * ate_odom, 1.0)
    # parity: our trajectory is at least as good as the reference-style one
    assert ate_ours <= ate_ref * 1.1


NOISE_XY, NOISE_TH = 0.02, 0.008
# seeds where the comparator itself tracks (it diverges on e.g. seed 7 at
# this noise — parity against a broken run would be meaningless)
SEEDS = (3, 21, 42)


def _loopy_log(sensor, seed, step=0.18):
    """Two laps around the inner rooms — drifty odometry, loop closure
    opportunities (the comparator has no backend; ours does)."""
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([
        [3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [8.0, 3.0],
        [3.0, 3.0], [3.0, 8.0], [8.0, 8.0],
    ])
    return world, simulate_log(
        world, wp, sensor, step=step,
        odom_noise_xy=NOISE_XY, odom_noise_theta=NOISE_TH, seed=seed,
    )


def _small_cfg(sensor):
    return FrontendConfig(
        sensor=sensor,
        grid=GridConfig(
            height=256, width=256, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=16,
    )


def test_fastslam_ate_parity_multi_seed():
    """FastSLAM-mode parity vs the comparator, 3 seeds (VERDICT r1 item 4:
    PF mode had no comparator check)."""
    from slam2d_tpu.config import PFConfig
    from slam2d_tpu.run.fastslam_run import run_fastslam

    sensor = SensorConfig(n_beams=120, max_range=12.0)
    cfg = _small_cfg(sensor)
    # proposal noise matched to the log's odometry noise — the per-dataset
    # tuning any FastSLAM deployment does (the 2x-larger default injects
    # pure jitter here: measured mean ATE 0.23 vs 0.12 matched)
    pf = PFConfig(
        n_particles=16, noise_xy=NOISE_XY, noise_theta=NOISE_TH
    )
    for seed in SEEDS:
        _, log = _loopy_log(sensor, seed)
        gt = log["gt_poses"]

        _, traj_pf, _, _ = run_fastslam(log, cfg, pf, seed=seed)
        ref = NumpyRefSLAM(n_beams=sensor.n_beams)
        traj_ref = ref.run(log, bootstrap=20)

        ate_pf = ate_rmse(traj_pf, gt, align=False)
        ate_ref = ate_rmse(traj_ref, gt, align=False)
        ate_odom = ate_rmse(log["odom"], gt, align=False)
        assert ate_ref < max(2.0 * ate_odom, 1.0), (seed, ate_ref, ate_odom)
        assert ate_pf <= ate_ref * 1.1, (seed, ate_pf, ate_ref, ate_odom)


def test_comparator_fails_seed7_we_track():
    """The regime the SEEDS tuple above excludes (VERDICT r4 weak item 6):
    at the standard config the comparator catastrophically diverges on
    seed 7 (measured 2.36 m ATE vs 0.19 odometry — a 1-in-45 aliased-match
    event; 45-seed scan, round 5). Our pipelines must not just stay
    bounded there but beat raw odometry — the regime where "beating the
    reference" is demonstrated rather than matched."""
    from slam2d_tpu.config import GraphConfig, PFConfig
    from slam2d_tpu.run.fastslam_run import run_fastslam
    from slam2d_tpu.run.full_slam import run_full_slam

    sensor = SensorConfig(n_beams=120, max_range=12.0)
    cfg = _small_cfg(sensor)
    _, log = _loopy_log(sensor, 7)
    gt = log["gt_poses"]
    ate_odom = ate_rmse(log["odom"], gt, align=False)

    ref = NumpyRefSLAM(n_beams=sensor.n_beams)
    ate_ref = ate_rmse(ref.run(log, bootstrap=20), gt, align=False)
    assert ate_ref > 1.0, f"comparator now tracks seed 7 ({ate_ref:.3f})"

    res = run_full_slam(log, cfg, GraphConfig(max_nodes=256, max_edges=1024))
    ate_full = ate_rmse(res.traj, gt, align=False)
    assert ate_full < ate_odom, (ate_full, ate_odom)

    pf = PFConfig(n_particles=16, noise_xy=NOISE_XY, noise_theta=NOISE_TH)
    _, traj_pf, _, _ = run_fastslam(log, cfg, pf, seed=7)
    ate_pf = ate_rmse(traj_pf, gt, align=False)
    assert ate_pf < ate_odom, (ate_pf, ate_odom)


def test_comparator_fails_lean_sensor_regime():
    """Systematic (not seed-luck) comparator failure: at 60 beams / 8 m
    range the comparator diverged on 12/12 seeds scanned (1.6-4.3 m ATE,
    round 5). Our full SLAM stays bounded on every seed (5-50x better
    than the comparator) and beats raw odometry where odometry is not
    exceptionally good (seeds 1, 9; on seed 0 the 0.22-ATE odometry wins
    — the fine-res-study phenomenon: near-perfect odometry defeats any
    matcher correction, both backends)."""
    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.run.full_slam import run_full_slam

    sensor = SensorConfig(n_beams=60, max_range=8.0)
    cfg = _small_cfg(sensor)
    for seed, must_beat_odom in ((1, True), (9, True), (0, False)):
        _, log = _loopy_log(sensor, seed)
        gt = log["gt_poses"]
        ate_odom = ate_rmse(log["odom"], gt, align=False)

        ref = NumpyRefSLAM(n_beams=sensor.n_beams)
        ate_ref = ate_rmse(ref.run(log, bootstrap=20), gt, align=False)
        assert ate_ref > 1.0, (seed, ate_ref)

        res = run_full_slam(
            log, cfg, GraphConfig(max_nodes=256, max_edges=1024)
        )
        ate_full = ate_rmse(res.traj, gt, align=False)
        assert ate_full < 0.35 * ate_ref, (seed, ate_full, ate_ref)
        assert ate_full < 0.6, (seed, ate_full)
        if must_beat_odom:
            assert ate_full < ate_odom, (seed, ate_full, ate_odom)


def test_full_slam_ate_parity_multi_seed():
    """Full-SLAM (config 5) parity on loop-heavy logs, 3 seeds: the
    comparator has no loop closure, so keyframe-corrected trajectories
    must at least match it."""
    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.run.full_slam import run_full_slam

    sensor = SensorConfig(n_beams=120, max_range=12.0)
    cfg = _small_cfg(sensor)
    gcfg = GraphConfig(max_nodes=256, max_edges=1024)
    for seed in SEEDS:
        _, log = _loopy_log(sensor, seed)
        gt = log["gt_poses"]

        res = run_full_slam(log, cfg, gcfg)
        ref = NumpyRefSLAM(n_beams=sensor.n_beams)
        traj_ref = ref.run(log, bootstrap=20)

        ate_full = ate_rmse(res.traj, gt, align=False)
        ate_ref = ate_rmse(traj_ref, gt, align=False)
        assert res.n_loops >= 1, seed
        assert ate_full <= ate_ref * 1.1, (seed, ate_full, ate_ref)
