"""The shared PF refinement's per-particle field (aligned_window ->
build_search_space) vs the same field built from a directly extracted,
zero-filled window — on f32 and bf16 maps, with priors that push the
window off every map edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam2d_tpu.config import GridConfig, MatcherConfig
from slam2d_tpu.grid.occupancy import cell_center_world, world_to_cell
from slam2d_tpu.match.correlative import build_search_space
from slam2d_tpu.pf.shared_refine import aligned_window


def _direct_window(g, a, b, win):
    """window[r, c] = g[a + r, b + c], 0 outside the map."""
    g = np.asarray(g, np.float32)
    Hm, Wm = g.shape
    w = np.zeros((win, win), np.float32)
    r0, r1 = max(0, -a), min(win, Hm - a)
    c0, c1 = max(0, -b), min(win, Wm - b)
    if r1 > r0 and c1 > c0:
        w[r0:r1, c0:c1] = g[a + r0 : a + r1, b + c0 : b + c1]
    return w


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_window_field_matches_direct_extraction(dtype):
    Hm, Wm, win = 128, 256, 96
    gcfg = GridConfig(height=Hm, width=Wm, resolution=0.1)
    mcfg = MatcherConfig(sigma_m=0.1)
    grids = jax.random.uniform(
        jax.random.PRNGKey(0), (5, Hm, Wm), minval=-4.0, maxval=4.0
    ).astype(dtype)
    # window origins: interior, off top-left, off bottom-right, half-off,
    # far corner
    origins = np.asarray(
        [[10, 50], [-20, -30], [Hm - 40, Wm - 40], [Hm - win // 2, 5],
         [-90, Wm - 8]]
    )
    centers = origins + win // 2
    priors = jnp.concatenate(
        [cell_center_world(jnp.asarray(centers, jnp.int32), gcfg),
         jnp.zeros((5, 1))], axis=1,
    )

    def field(grid, prior):
        gw, _ = aligned_window(grid, prior, gcfg, win)
        return build_search_space(gw.astype(jnp.float32), mcfg, 0.1)

    got = np.asarray(jax.vmap(field)(grids, priors))
    for p, (a, b) in enumerate(origins):
        w = _direct_window(grids[p].astype(jnp.float32), a, b, win)
        want = np.asarray(build_search_space(jnp.asarray(w), mcfg, 0.1))
        np.testing.assert_allclose(got[p], want, atol=2e-6, rtol=1e-5)


def test_aligned_window_origin_semantics():
    """aligned_window == direct unclamped extraction with zero fill, and
    its anchor is the prior's cell center."""
    gcfg = GridConfig(height=64, width=128, resolution=0.1)
    g = jax.random.uniform(jax.random.PRNGKey(1), (64, 128))
    win = 32
    for prior_xy in [(1.0, 0.5), (0.2, 0.1), (12.0, 6.0)]:
        prior = jnp.asarray([prior_xy[0], prior_xy[1], 0.0])
        gw, anchor = aligned_window(g, prior, gcfg, win)
        center = np.asarray(world_to_cell(prior[:2], gcfg))
        a, b = int(center[0]) - win // 2, int(center[1]) - win // 2
        np.testing.assert_allclose(np.asarray(gw), _direct_window(g, a, b, win))
        np.testing.assert_allclose(
            np.asarray(anchor),
            np.asarray(cell_center_world(jnp.asarray(center), gcfg)),
        )
