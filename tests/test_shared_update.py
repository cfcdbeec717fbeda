"""Shared-anchor PF map update (pf/shared_update.py) vs the per-particle
path."""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import (
    FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.pf.fastslam import _update_all
from slam2d_tpu.pf.shared_update import shared_update

CFG = FrontendConfig(
    sensor=SensorConfig(n_beams=60, max_range=8.0),
    grid=GridConfig(height=224, width=224, resolution=0.1,
                    ray_samples=96, center_x=8.0, center_y=8.0),
    matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=7),
    chunk=8,
)


def _ranges(seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 7.5, CFG.sensor.n_beams).astype(np.float32)
    return jnp.asarray(r)


def test_shared_matches_per_particle_on_lattice():
    """Poses placed exactly at cell centers with slot-aligned headings:
    the shared path's quantization is a no-op, so its marks must match
    the per-particle integrate (up to rare 1-ulp endpoint cell flips
    from the shifted coordinate frame)."""
    pf = PFConfig(n_particles=8, update_theta_slots=16,
                  update_exact_endpoints=False)
    res = CFG.grid.resolution
    rng = np.random.default_rng(1)
    # cell-center positions, identical heading (= the center slot exactly)
    cells = rng.integers(60, 160, (8, 2))
    xy = np.stack([
        CFG.grid.origin_x + (cells[:, 1] + 0.5) * res,
        CFG.grid.origin_y + (cells[:, 0] + 0.5) * res,
    ], axis=1)
    poses = jnp.asarray(
        np.concatenate([xy, np.full((8, 1), 0.37)], axis=1), jnp.float32
    )
    maps = jnp.zeros((8, 224, 224), jnp.float32)
    ranges = _ranges()

    shared = np.asarray(shared_update(maps, poses, ranges, CFG, pf))
    per = np.asarray(
        _update_all(
            maps, poses, ranges, CFG,
            dataclasses.replace(pf, update_mode="per_particle"),
        )
    )
    diff = np.abs(shared - per)
    # almost everywhere identical; allow a handful of boundary-cell flips
    frac_mismatch = (diff > 1e-4).mean()
    assert frac_mismatch < 2e-3, frac_mismatch
    # total evidence mass matches closely
    assert abs(shared.sum() - per.sum()) < 0.02 * abs(per.sum())


def test_shared_quantization_error_bounded():
    """Arbitrary (off-lattice) poses: shared marks displace by at most
    ~1 cell from the per-particle marks — wall cells stay adjacent."""
    pf = PFConfig(n_particles=6, update_theta_slots=16,
                  update_exact_endpoints=False)
    rng = np.random.default_rng(2)
    poses = jnp.asarray(np.stack([
        rng.uniform(7.0, 9.0, 6), rng.uniform(7.0, 9.0, 6),
        rng.uniform(-0.1, 0.1, 6),
    ], axis=1), jnp.float32)
    maps = jnp.zeros((6, 224, 224), jnp.float32)
    ranges = _ranges(3)

    shared = np.asarray(shared_update(maps, poses, ranges, CFG, pf))
    per = np.asarray(
        _update_all(
            maps, poses, ranges, CFG,
            dataclasses.replace(pf, update_mode="per_particle"),
        )
    )

    for p in range(6):
        occ_s = shared[p] > 0.4
        occ_p = per[p] > 0.4
        # every shared occ cell within 2 cells of a per-particle occ cell
        grown = occ_p.copy()
        for _ in range(2):
            g2 = grown.copy()
            g2[1:] |= grown[:-1]
            g2[:-1] |= grown[1:]
            g2[:, 1:] |= grown[:, :-1]
            g2[:, :-1] |= grown[:, 1:]
            grown = g2
        stray = occ_s & ~grown
        assert stray.sum() <= max(2, 0.02 * occ_s.sum()), stray.sum()


def test_bilinear_apply_centroid_exact():
    """update_bilinear mechanics: a delta image placed with a fractional
    offset must land its MASS CENTROID exactly at anchor + frac; without
    the blend it snaps to the anchor cell. (Point-wise L1 vs the exact
    update is the wrong metric — the blend intentionally spreads mass
    across the 2x2 neighbors.)"""
    from slam2d_tpu.pf.shared_update import apply_images, bilinear_place

    win = 64
    H = 256
    P = 4
    img = jnp.zeros((P, win, win), jnp.float32).at[:, win // 2, win // 2].set(1.0)
    anchors = jnp.asarray([[100, 100], [40, 200], [128, 64], [77, 133]],
                          jnp.int32)
    frac = jnp.asarray(
        [[0.25, -0.3], [-0.49, 0.49], [0.0, 0.0], [0.37, 0.12]], jnp.float32
    )
    out = apply_images(
        jnp.zeros((P, H, H), jnp.float32), anchors, bilinear_place(img, frac),
        win, 10.0,
    )
    out = np.asarray(out)
    ri = np.arange(H)
    for p in range(P):
        m = out[p]
        tot = m.sum()
        assert abs(tot - 1.0) < 1e-5, (p, tot)
        cr = (m.sum(1) * ri).sum() / tot
        cc = (m.sum(0) * ri).sum() / tot
        want_r = anchors[p, 0] + frac[p, 0]
        want_c = anchors[p, 1] + frac[p, 1]
        assert abs(cr - float(want_r)) < 1e-5, (p, cr, float(want_r))
        assert abs(cc - float(want_c)) < 1e-5, (p, cc, float(want_c))

    snapped = np.asarray(apply_images(
        jnp.zeros((P, H, H), jnp.float32), anchors, img, win, 10.0,
    ))
    for p in range(P):
        r, c = np.unravel_index(np.argmax(snapped[p]), snapped[p].shape)
        assert (r, c) == (int(anchors[p, 0]), int(anchors[p, 1])), (p, r, c)


def test_bilinear_update_matches_snapped_on_lattice():
    """update_bilinear through shared_update: at cell-center poses (zero
    fractional offset) the blend is the identity, so the result equals the
    snapped update (to the f32 rounding of the cell-center offset);
    off-lattice it redistributes but preserves the evidence mass."""
    pf = PFConfig(n_particles=6, update_theta_slots=16, update_bilinear=True,
                  update_exact_endpoints=False)
    pf_snap = dataclasses.replace(pf, update_bilinear=False)
    cfg = dataclasses.replace(
        CFG, grid=dataclasses.replace(CFG.grid, height=256, width=256),
    )
    res = cfg.grid.resolution
    rng = np.random.default_rng(13)
    cells = rng.integers(80, 170, (6, 2))
    on = np.stack([
        cfg.grid.origin_x + (cells[:, 1] + 0.5) * res,
        cfg.grid.origin_y + (cells[:, 0] + 0.5) * res,
        rng.uniform(-0.1, 0.1, 6),
    ], axis=1).astype(np.float32)
    ranges = _ranges(17)
    maps0 = jnp.zeros((6, 256, 256), jnp.float32)
    a = np.asarray(shared_update(maps0, jnp.asarray(on), ranges, cfg, pf))
    b = np.asarray(shared_update(maps0, jnp.asarray(on), ranges, cfg, pf_snap))
    np.testing.assert_allclose(a, b, atol=2e-4)
    off = on.copy()
    off[:, :2] += rng.uniform(-0.04, 0.04, (6, 2)).astype(np.float32)
    a = np.asarray(shared_update(maps0, jnp.asarray(off), ranges, cfg, pf))
    b = np.asarray(shared_update(maps0, jnp.asarray(off), ranges, cfg, pf_snap))
    np.testing.assert_allclose(a.sum(axis=(1, 2)), b.sum(axis=(1, 2)),
                               rtol=1e-4)
    assert np.abs(a - b).max() > 0.01


def test_quantized_per_particle_matches_shared_marks():
    """update_mode="quantized_per_particle" (the exact kernel at
    shared_update's quantized poses — the VERDICT r2 item-3 diagnostic)
    must mark maps like the shared path: same quantization semantics,
    different mechanics."""
    pf = PFConfig(n_particles=6, update_theta_slots=16,
                  update_exact_endpoints=False)
    rng = np.random.default_rng(5)
    poses = jnp.asarray(np.stack([
        rng.uniform(7.0, 9.0, 6), rng.uniform(7.0, 9.0, 6),
        rng.uniform(-0.1, 0.1, 6),
    ], axis=1), jnp.float32)
    maps = jnp.zeros((6, 224, 224), jnp.float32)
    ranges = _ranges(7)

    shared = np.asarray(
        shared_update(jnp.array(maps), poses, ranges, CFG, pf)
    )
    qpp = np.asarray(
        _update_all(
            maps, poses, ranges, CFG,
            dataclasses.replace(pf, update_mode="quantized_per_particle"),
        )
    )
    # same quantized poses -> near-identical marks (rare boundary-cell
    # flips from the image frame's shifted arithmetic allowed)
    frac_mismatch = (np.abs(shared - qpp) > 1e-4).mean()
    assert frac_mismatch < 2e-3, frac_mismatch
    assert abs(shared.sum() - qpp.sum()) < 0.02 * abs(qpp.sum())


def test_fastslam_ate_with_shared_update():
    """End-to-end PF with the shared update forced on: tracking quality
    holds vs the per-particle path on the same log."""
    from slam2d_tpu.run.fastslam_run import run_fastslam

    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 7.0], [7.0, 7.0]])
    cfg = dataclasses.replace(
        CFG,
        grid=GridConfig(height=160, width=160, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0),
    )
    log = simulate_log(world, wp, cfg.sensor, step=0.2,
                       odom_noise_xy=0.02, odom_noise_theta=0.008, seed=4)
    gt = log["gt_poses"]
    pf_pp = PFConfig(n_particles=8, update_mode="per_particle",
                     noise_xy=0.02, noise_theta=0.008)
    pf_sh = dataclasses.replace(pf_pp, update_mode="shared")
    _, tr_pp, _, _ = run_fastslam(log, cfg, pf_pp, seed=1)
    _, tr_sh, _, _ = run_fastslam(log, cfg, pf_sh, seed=1)
    a_pp = ate_rmse(tr_pp, gt, align=False)
    a_sh = ate_rmse(tr_sh, gt, align=False)
    a_od = ate_rmse(log["odom"], gt, align=False)
    assert a_sh < max(1.5 * a_pp, 0.8 * a_od), (a_sh, a_pp, a_od)


def test_subcell_anchors_reduce_quantization():
    """update_subcell=2 (quarter-cell anchor images) must land marks
    strictly closer to the exact per-particle update than cell-center
    anchoring, and stay within the apply kernel's supported path."""
    import dataclasses

    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
    )
    from slam2d_tpu.grid.occupancy import raycast_update
    from slam2d_tpu.pf.shared_update import shared_update

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=48, max_range=6.0),
        grid=GridConfig(height=256, width=256, resolution=0.1,
                        ray_samples=64, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=5),
    )
    rng = np.random.default_rng(1)
    P = 12
    poses = jnp.asarray(
        np.concatenate(
            [rng.uniform(9.0, 11.0, (P, 2)), rng.uniform(-0.3, 0.3, (P, 1))],
            axis=1,
        ).astype(np.float32)
    )
    ranges = jnp.asarray(rng.uniform(1.0, 5.5, 48).astype(np.float32))
    maps0 = jnp.zeros((P, 256, 256), jnp.float32)

    exact = jax.vmap(
        lambda p: raycast_update(
            jnp.zeros((256, 256), jnp.float32), p, ranges,
            cfg.grid, cfg.sensor,
        )
    )(poses)

    errs = {}
    for q in (1, 2):
        pf = PFConfig(n_particles=P, update_mode="shared",
                      update_theta_slots=8, update_subcell=q,
                      update_exact_endpoints=False)
        out = shared_update(jnp.array(maps0), poses, ranges, cfg, pf)
        errs[q] = float(jnp.mean(jnp.abs(out - exact)))
    assert errs[2] < errs[1], errs


def test_exact_endpoints_match_per_particle_marks():
    """update_exact_endpoints (round-4 fix for the xy-quantization gap):
    OFF-lattice poses — every occupancy mark must land at the particle's
    EXACT endpoint cell (identical to the per-particle sparse path's
    endpoint section), while the free-space carve keeps the anchor snap.
    The snapped mode displaces marks by up to a cell; exact mode by 0."""
    from slam2d_tpu.grid.occupancy import beam_angles

    pf = PFConfig(n_particles=6, update_theta_slots=16,
                  update_exact_endpoints=True)
    rng = np.random.default_rng(7)
    poses_n = np.stack([
        rng.uniform(7.0, 9.0, 6), rng.uniform(7.0, 9.0, 6),
        rng.uniform(-0.1, 0.1, 6),
    ], axis=1).astype(np.float32)
    poses = jnp.asarray(poses_n)
    maps = jnp.zeros((6, 224, 224), jnp.float32)
    ranges = _ranges(5)

    out = np.asarray(
        shared_update(jnp.array(maps), poses, ranges, CFG, pf)
    )
    snapped = np.asarray(shared_update(
        jnp.array(maps), poses, ranges, CFG,
        dataclasses.replace(pf, update_exact_endpoints=False),
    ))
    per = np.asarray(
        _update_all(
            maps, poses, ranges, CFG,
            dataclasses.replace(pf, update_mode="per_particle"),
        )
    )

    g = CFG.grid
    r = np.asarray(ranges)
    ang = np.asarray(beam_angles(CFG.sensor))
    hit = (r > CFG.sensor.min_range) & (r < CFG.sensor.max_range)
    for p in range(6):
        ex = poses_n[p, 0] + np.cos(ang + poses_n[p, 2]) * r
        ey = poses_n[p, 1] + np.sin(ang + poses_n[p, 2]) * r
        ec = np.floor((ex - g.origin_x) / g.resolution).astype(int)
        er = np.floor((ey - g.origin_y) / g.resolution).astype(int)
        inb = (er >= 0) & (er < 224) & (ec >= 0) & (ec < 224) & hit
        vals = out[p][er[inb], ec[inb]]
        vals_snap = snapped[p][er[inb], ec[inb]]
        vals_per = per[p][er[inb], ec[inb]]
        # most exact endpoint cells carry strong positive evidence (a few
        # lose some to neighboring beams' laterally-snapped carve — the
        # snap the shared carve keeps by design)
        assert (vals > 0.3).mean() > 0.85, (vals.min(), (vals > 0.3).mean())
        assert np.median(vals) >= 0.8 * g.l_occ
        # and at the endpoint cells the exact mode tracks the per-particle
        # update far better than the snapped mode does
        err_exact = np.abs(vals - vals_per).mean()
        err_snap = np.abs(vals_snap - vals_per).mean()
        assert err_exact < 0.5 * err_snap, (err_exact, err_snap)


def test_exact_endpoints_bf16_maps_track_f32():
    """The exact-endpoint shared update on the production bf16 map dtype
    (images follow the map dtype) tracks the f32 run within bf16
    rounding, near the map border and in the interior, and the marks are
    actually there."""
    cfg = dataclasses.replace(
        CFG,
        grid=dataclasses.replace(
            CFG.grid, height=512, width=512, center_x=25.0, center_y=25.0
        ),
    )
    P = 6
    rng = np.random.default_rng(3)
    poses = np.tile(np.array([[25.0, 25.0, 0.2]], np.float32), (P, 1))
    poses[:, :2] += rng.normal(0, 0.3, (P, 2))
    poses[:, 2] += rng.normal(0, 0.08, P)
    poses[0, :2] = [0.4, 49.7]              # window hangs off the map corner
    r = rng.uniform(0.5, 7.5, CFG.sensor.n_beams).astype(np.float32)
    r[::5] = CFG.sensor.max_range          # no-hit beams stay masked
    maps0 = rng.normal(0, 0.5, (P, 512, 512)).astype(np.float32)
    pf = PFConfig(n_particles=P)
    outs = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        m = jnp.asarray(maps0, dtype)
        out = shared_update(m, jnp.asarray(poses), jnp.asarray(r), cfg, pf)
        assert out.dtype == dtype
        outs[dtype] = np.asarray(out, np.float32)
    # bf16 ulp at |logodds| <= 4 is 2^-6; two roundings (map, sum)
    np.testing.assert_allclose(outs[jnp.bfloat16], outs[jnp.float32],
                               atol=0.04)
    assert np.abs(outs[jnp.float32] - maps0).max() > 0.5
