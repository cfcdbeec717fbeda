"""Dense inverse-sensor-model update (grid.occupancy.raycast_update_dense,
update_impl="dense") against a NumPy statement of the same model, plus its
edge cases: enable gate, window origin, short ranges, all-invalid scans,
bf16 maps."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import GridConfig, SensorConfig
from slam2d_tpu.data.synth import SynthWorld
from slam2d_tpu.grid.occupancy import (
    integrate_scan,
    make_grid,
    raycast_update_dense,
)

GCFG = GridConfig(height=256, width=256, resolution=0.1)
SENSOR = SensorConfig(n_beams=90, max_range=8.0)


def _scan():
    world = SynthWorld.box_rooms(12.0)
    pose_np = np.array([6.3, 5.8, 0.4])
    r = world.raycast(
        pose_np, np.asarray(SENSOR.beam_angles()), SENSOR.max_range
    )
    # pose relative to the grid center (grid center is world (0, 0))
    return jnp.asarray([0.3, -0.2, 0.4], jnp.float32), jnp.asarray(r, jnp.float32)


def _numpy_ism(pose, ranges, g: GridConfig, s: SensorConfig):
    """Nearest-beam inverse sensor model (Probabilistic Robotics ch. 9)
    with the neighbour-beam grazing guard, in float64 NumPy."""
    pose = np.asarray(pose, np.float64)
    raw = np.asarray(ranges, np.float64)
    r = np.clip(raw, 0.0, s.max_range)
    valid = (raw > s.min_range) & np.isfinite(raw)
    hit = valid & (raw < s.max_range)
    B = s.n_beams
    step = s.fov_rad / (B - 1)
    rows, cols = np.mgrid[0 : g.height, 0 : g.width].astype(np.float64)
    cx = g.origin_x + (cols + 0.5) * g.resolution - pose[0]
    cy = g.origin_y + (rows + 0.5) * g.resolution - pose[1]
    d = np.hypot(cx, cy)
    phi = np.mod(np.arctan2(cy, cx) - pose[2] - s.angle_min, 2 * np.pi)
    k = np.round(phi / step).astype(int)
    in_fov = k < B
    k = np.clip(k, 0, B - 1)
    k2 = np.clip(k + np.where(phi - k * step >= 0, 1, -1), 0, B - 1)

    def occ_of(kk):
        cross = np.abs(phi - kk * step) * d
        return (
            hit[kk]
            & (np.abs(d - r[kk]) <= 0.75 * g.resolution)
            & (cross <= 0.75 * g.resolution)
        )

    r_min = np.where(valid[k2], np.minimum(r[k], r[k2]), r[k])
    free = in_fov & valid[k] & (d < r_min - g.resolution)
    occ = in_fov & (occ_of(k) | occ_of(k2))
    return g.l_free * free + g.l_occ * occ


def test_dense_matches_numpy_inverse_sensor_model():
    pose, ranges = _scan()
    got = np.asarray(
        raycast_update_dense(make_grid(GCFG), pose, ranges, GCFG, SENSOR)
    )
    want = _numpy_ism(pose, ranges, GCFG, SENSOR)
    # f32 vs f64 geometry flips only cells sitting on a threshold
    mismatch = np.abs(got - want) > 1e-5
    assert mismatch.mean() < 2e-3, mismatch.sum()
    assert (want > 0).sum() > 50 and (want < 0).sum() > 500


def test_dense_enable_gate_bf16():
    pose, ranges = _scan()
    grid = make_grid(GCFG, dtype=jnp.bfloat16)
    out = raycast_update_dense(grid, pose, ranges, GCFG, SENSOR, enable=0.0)
    assert out.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out, np.float32), 0.0)


def test_dense_window_origin_rc_matches_full_grid():
    """integrate_scan(update_impl="dense") on a window with an integer
    lattice origin equals the same cells of the full-grid update."""
    pose, ranges = _scan()
    g = dataclasses.replace(GCFG, update_impl="dense")
    full = np.asarray(integrate_scan(make_grid(g), pose, ranges, g, SENSOR))
    r0, c0, win = 40, 72, 160
    orc = jnp.asarray([r0, c0], jnp.int32)
    w = integrate_scan(
        jnp.zeros((win, win), jnp.float32), pose, ranges, g, SENSOR,
        origin_rc=orc,
    )
    np.testing.assert_allclose(
        np.asarray(w), full[r0 : r0 + win, c0 : c0 + win], atol=1e-6
    )


def test_dense_short_ranges_touch_only_the_disk():
    """Ranges far below max_range: cells beyond the touchable disk stay
    exactly zero, and near cells carry both free and occupied marks."""
    pose = jnp.asarray([0.3, -0.2, 0.4], jnp.float32)
    ranges = jnp.full((SENSOR.n_beams,), 1.5, jnp.float32)
    b = np.asarray(
        raycast_update_dense(make_grid(GCFG), pose, ranges, GCFG, SENSOR)
    )
    H, W = b.shape
    ys = (np.arange(H) + 0.5) * GCFG.resolution + GCFG.origin_y - pose[1]
    xs = (np.arange(W) + 0.5) * GCFG.resolution + GCFG.origin_x - pose[0]
    d = np.hypot(ys[:, None], xs[None, :])
    far = d > 1.5 + 0.75 * GCFG.resolution
    np.testing.assert_array_equal(b[far], 0.0)
    assert (b > 0.5).sum() > 0 and (b < -0.05).sum() > 0


def test_dense_all_invalid_scan_is_identity():
    """No valid beams (all at/below min_range, NaN, or inf): the output is
    the input map, clamped, bit for bit."""
    pose = jnp.asarray([0.3, -0.2, 0.4], jnp.float32)
    ranges = jnp.asarray(
        [0.0] * 30 + [np.nan] * 30 + [np.inf] * 30, jnp.float32
    )
    rng = np.random.default_rng(0)
    grid = jnp.asarray(rng.normal(0, 4, (256, 256)).astype(np.float32))
    out = raycast_update_dense(grid, pose, ranges, GCFG, SENSOR)
    np.testing.assert_array_equal(
        np.asarray(out), np.clip(np.asarray(grid), -GCFG.l_clamp, GCFG.l_clamp)
    )


def test_dense_bf16_tracks_f32():
    pose, ranges = _scan()
    out = raycast_update_dense(
        make_grid(GCFG, dtype=jnp.bfloat16), pose, ranges, GCFG, SENSOR
    )
    assert out.dtype == jnp.bfloat16
    ref = raycast_update_dense(make_grid(GCFG), pose, ranges, GCFG, SENSOR)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref), atol=0.02
    )
