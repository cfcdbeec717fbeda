"""The shared PF update's per-particle windowed add
(pf.shared_update.apply_images) vs a NumPy oracle — including map-border
anchors where image cells must DROP."""

import numpy as np
import pytest

import jax.numpy as jnp

from slam2d_tpu.pf.shared_update import apply_images

WIN = 64
L_CLAMP = 10.0


def oracle(maps, anchors, slots, images):
    """Window centred on the anchor cell; image cells outside the map
    drop; the sum clamps to +-L_CLAMP and rounds to the map dtype."""
    maps = np.asarray(maps, np.float32)
    out = maps.copy()
    P, Hm, Wm = maps.shape
    for p in range(P):
        a, b = np.asarray(anchors[p]) - WIN // 2
        img = np.asarray(images[int(slots[p])], np.float32)
        for i in range(WIN):
            r = a + i
            if not 0 <= r < Hm:
                continue
            c_lo, c_hi = max(0, b), min(Wm, b + WIN)
            out[p, r, c_lo:c_hi] += img[i, c_lo - b : c_hi - b]
    return np.clip(out, -L_CLAMP, L_CLAMP)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matches_oracle_including_borders(dtype):
    P, Hm, Wm, G = 7, 256, 256, 3
    rng = np.random.default_rng(0)
    maps = jnp.asarray(
        rng.normal(0, 2, (P, Hm, Wm)).astype(np.float32)
    ).astype(dtype)
    # corners (image partially out of map), edges, interior
    anchors = jnp.asarray(
        [[0, 0], [2, 250], [255, 255], [128, 128], [100, 3],
         [254, 30], [31, 127]], jnp.int32
    )
    slots = rng.integers(0, G, P)
    images = jnp.asarray(
        rng.normal(0, 0.5, (G, WIN, WIN)).astype(np.float32)
    )
    want = oracle(maps, anchors, slots, images)
    got = apply_images(maps, anchors, images[slots], WIN, L_CLAMP)
    assert got.dtype == dtype
    # the oracle's f32 sum rounds to the map dtype exactly as the kernel's
    want = np.asarray(jnp.asarray(want).astype(dtype).astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


def test_clip_binds_and_chunking():
    P, Hm, Wm = 4, 256, 256
    maps = jnp.full((P, Hm, Wm), 9.9, jnp.float32)
    anchors = jnp.asarray([[128, 128], [0, 255], [60, 9], [250, 250]],
                          jnp.int32)
    slots = np.zeros(P, int)
    images = jnp.full((1, WIN, WIN), 5.0, jnp.float32)
    want = oracle(maps, anchors, slots, images)
    out = np.asarray(apply_images(maps, anchors, images[slots], WIN, L_CLAMP))
    assert out.max() == L_CLAMP
    np.testing.assert_array_equal(out, want)
    # lax.map chunks (refine_chunk) give the same result
    chunked = apply_images(maps, anchors, images[slots], WIN, L_CLAMP, chunk=2)
    np.testing.assert_array_equal(np.asarray(chunked), out)
