"""Shared-anchor batched PF refinement (pf/shared_refine.py) vs the
per-particle matcher, plus accuracy and end-to-end PF properties."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid.occupancy import cell_center_world, integrate_scan, world_to_cell
from slam2d_tpu.match.correlative import match_scan
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.pf.fastslam import refine_matcher
from slam2d_tpu.pf.shared_refine import shared_refine
from slam2d_tpu.run.fastslam_run import run_fastslam

SENSOR = SensorConfig(n_beams=120, max_range=8.0)
GCFG = GridConfig(
    height=224, width=224, resolution=0.1, ray_samples=96,
    center_x=8.0, center_y=8.0,
)
MCFG = MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9)
CFG = FrontendConfig(sensor=SENSOR, grid=GCFG, matcher=MCFG, chunk=8)


def _scan(world, pose):
    angles = np.asarray(SENSOR.beam_angles())
    return world.raycast(np.asarray(pose, np.float64), angles, SENSOR.max_range).astype(
        np.float32
    )


def _mapped_world():
    world = SynthWorld.box_rooms(16.0)
    true_pose = np.array([8.3, 7.6, 0.35], np.float32)
    ranges = _scan(world, true_pose)
    grid = jnp.zeros((GCFG.height, GCFG.width), jnp.float32)
    # build a map from a few nearby viewpoints so the field has structure
    for dp in ([0, 0, 0], [0.3, 0.1, 0.1], [-0.2, 0.2, -0.08]):
        p = true_pose + np.asarray(dp, np.float32)
        r = _scan(world, p)
        grid = integrate_scan(grid, jnp.asarray(p), jnp.asarray(r), GCFG, SENSOR)
    return grid, true_pose, jnp.asarray(ranges)


def test_matches_per_particle_at_cell_center_prior():
    """With the prior exactly on a cell center and zero heading spread, the
    shared path's candidate lattice coincides with match_scan's — the
    refined poses must agree."""
    grid, true_pose, ranges = _mapped_world()
    # snap the true pose's cell center as the prior
    rc = world_to_cell(jnp.asarray(true_pose[:2]), GCFG)
    xy = cell_center_world(rc, GCFG)
    prior = jnp.asarray([xy[0], xy[1], true_pose[2]], jnp.float32)

    pose_ref, score_ref = match_scan(
        grid, ranges, prior, GCFG, MCFG, SENSOR
    )
    pf = PFConfig(n_particles=2, refine_theta_pad=2)
    priors = jnp.stack([prior, prior])
    poses, scores = shared_refine(
        jnp.stack([grid, grid]), ranges, priors, CFG, MCFG, pf
    )
    np.testing.assert_allclose(
        np.asarray(poses[0]), np.asarray(poses[1]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(poses[0]), np.asarray(pose_ref), atol=0.06
    )
    assert abs(float(scores[0]) - float(score_ref)) < 0.05


def test_recovers_known_offset_with_heading_spread():
    """Particles displaced from the true pose (within the search window,
    with differing headings) refine back to the true pose."""
    grid, true_pose, ranges = _mapped_world()
    rng = np.random.default_rng(1)
    P = 8
    priors = np.tile(true_pose, (P, 1)).astype(np.float32)
    priors[:, 0] += rng.uniform(-0.15, 0.15, P)
    priors[:, 1] += rng.uniform(-0.15, 0.15, P)
    priors[:, 2] += rng.uniform(-0.05, 0.05, P)
    pf = PFConfig(n_particles=P)
    poses, scores = shared_refine(
        jnp.tile(grid[None], (P, 1, 1)), ranges, jnp.asarray(priors),
        CFG, MCFG, pf,
    )
    poses = np.asarray(poses)
    err = np.hypot(*(poses[:, :2] - true_pose[:2]).T)
    # parity bar: the per-particle matcher on the same inputs reaches
    # max xy error 0.112 / mean 0.060 at this map's texture
    assert err.max() < 0.13 and err.mean() < 0.08, err
    assert np.all(np.abs(poses[:, 2] - true_pose[2]) < 0.04)
    assert np.all(np.asarray(scores) > MCFG.min_score)


def test_refine_chunked_matches_unchunked():
    grid, true_pose, ranges = _mapped_world()
    rng = np.random.default_rng(2)
    P = 8
    priors = np.tile(true_pose, (P, 1)).astype(np.float32)
    priors += rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    grids = jnp.tile(grid[None], (P, 1, 1))
    a = shared_refine(
        grids, ranges, jnp.asarray(priors), CFG, MCFG, PFConfig(n_particles=P)
    )
    b = shared_refine(
        grids, ranges, jnp.asarray(priors), CFG, MCFG,
        PFConfig(n_particles=P, refine_chunk=4),
    )
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=1e-5)


def test_fastslam_shared_mode_beats_odometry():
    cfg = dataclasses.replace(CFG, bootstrap_dist=1.0)
    world = SynthWorld.box_rooms(16.0)
    wp = np.array([[3.0, 3.0], [3.0, 9.0], [9.0, 9.0], [11.0, 4.0]])
    log = simulate_log(
        world, wp, cfg.sensor, step=0.12,
        odom_noise_xy=0.03, odom_noise_theta=0.012, seed=11,
    )
    pf = PFConfig(n_particles=24, refine_mode="shared")
    _, traj, n_eff, _ = run_fastslam(log, cfg, pf)
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    assert np.isfinite(np.asarray(traj)).all()
    assert ate < ate_odom, (ate, ate_odom)


def test_far_heading_particle_keeps_prior():
    """A particle whose heading drifted beyond every padded global-theta
    slot has all candidates masked — it must keep its prior, never snap
    toward the swarm mean (the mask fails CLOSED)."""
    grid, true_pose, ranges = _mapped_world()
    P = 8
    priors = np.tile(true_pose, (P, 1)).astype(np.float32)
    priors[0, 2] += 1.2  # far outside search_theta + pad*step
    pf = PFConfig(n_particles=P)
    poses, scores = shared_refine(
        jnp.tile(grid[None], (P, 1, 1)), ranges, jnp.asarray(priors),
        CFG, MCFG, pf,
    )
    np.testing.assert_allclose(np.asarray(poses[0]), priors[0], atol=1e-6)


def test_explicit_shared_mode_rejects_theta_less_matcher():
    import pytest

    from slam2d_tpu.pf.fastslam import _resolve_refine_mode

    mcfg = dataclasses.replace(MCFG, n_theta=1)
    with pytest.raises(ValueError):
        _resolve_refine_mode(
            PFConfig(n_particles=8, refine_mode="shared"), mcfg
        )
    # auto silently falls back instead
    assert (
        _resolve_refine_mode(
            PFConfig(n_particles=64, refine_mode="auto"), mcfg
        )
        == "per_particle"
    )
