"""The sampled-ray update's two accumulators (update_impl "sparse" =
scatter-add, "sparse_mxu" = one-hot matmul) agree, and the exact-endpoint
pass (grid.occupancy.endpoint_update) marks exactly the sparse update's
occupied cells."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from slam2d_tpu.config import GridConfig, SensorConfig
from slam2d_tpu.grid.occupancy import endpoint_update, raycast_update

GCFG = GridConfig(height=128, width=128, resolution=0.1,
                  center_x=6.0, center_y=6.0, ray_samples=192,
                  l_clamp=1000.0)   # no clamp: compare raw accumulations
SENSOR = SensorConfig(n_beams=60, max_range=6.0)


def _scan(seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 7.0, SENSOR.n_beams).astype(np.float32)
    r[rng.uniform(size=SENSOR.n_beams) < 0.2] = 81.9   # no-hit beams
    return jnp.asarray(r)


def test_mxu_accumulation_matches_scatter():
    pose = jnp.asarray([6.3, 5.8, 0.7], jnp.float32)
    zeros = jnp.zeros((GCFG.height, GCFG.width), jnp.float32)
    for seed in (0, 1):
        ranges = _scan(seed)
        sc = np.asarray(raycast_update(zeros, pose, ranges, GCFG, SENSOR))
        mx = np.asarray(
            raycast_update(zeros, pose, ranges, GCFG, SENSOR,
                           accumulate="mxu")
        )
        # the same samples land in the same cells; the matmul rounds each
        # weight to bf16 (relative 2^-9), so per-cell sums agree to ~0.4%
        assert ((sc != 0) == (mx != 0)).all()
        np.testing.assert_allclose(mx, sc, rtol=5e-3, atol=5e-3)
        assert abs(mx.sum() - sc.sum()) < 5e-3 * abs(sc).sum()


@pytest.mark.parametrize("accumulate", ["scatter", "mxu"])
def test_endpoint_update_matches_sparse_occupied_channel(accumulate):
    """With l_free=0 the sparse update is its endpoint section alone, and
    endpoint_update must reproduce it exactly (same cells, same l_occ
    stacking) — also inside a window with an integer lattice origin."""
    pose = jnp.asarray([5.5, 6.2, -1.2], jnp.float32)
    ranges = _scan(3)
    g_occ = dataclasses.replace(GCFG, l_free=0.0)
    zeros = jnp.zeros((GCFG.height, GCFG.width), jnp.float32)
    want = np.asarray(
        raycast_update(zeros, pose, ranges, g_occ, SENSOR,
                       accumulate=accumulate)
    )
    got = np.asarray(
        endpoint_update(zeros, pose, ranges, g_occ, SENSOR,
                        accumulate=accumulate)
    )
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 20
    r0, c0, win = 20, 30, 90
    w = endpoint_update(
        jnp.zeros((win, win), jnp.float32), pose, ranges, g_occ, SENSOR,
        origin_rc=jnp.asarray([r0, c0], jnp.int32), accumulate=accumulate,
    )
    np.testing.assert_array_equal(
        np.asarray(w), want[r0 : r0 + win, c0 : c0 + win]
    )
