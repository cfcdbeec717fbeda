"""One-hot-matmul scorer == gather scorer (f32, CPU)."""

import jax.numpy as jnp
import numpy as np

from slam2d_tpu.match.correlative import score_offsets


def _inputs(seed=0, T=5, B=40, H=128, W=128):
    rng = np.random.default_rng(seed)
    S = jnp.asarray(rng.normal(size=(H, W)).astype(np.float32))
    prior = jnp.asarray([3.1, 2.9, 0.4], jnp.float32)
    pts = jnp.asarray(rng.uniform(-2.5, 2.5, (B, 2)).astype(np.float32))
    valid = jnp.asarray(rng.uniform(size=B) > 0.2)
    dthetas = jnp.asarray(np.linspace(-0.2, 0.2, T), jnp.float32)
    offs = jnp.arange(-4, 5, dtype=jnp.int32)
    origin = jnp.asarray([-3.0, -3.0], jnp.float32)
    return S, prior, pts, valid, dthetas, offs, origin


def test_mxu_matches_gather_nearest():
    S, prior, pts, valid, dthetas, offs, origin = _inputs()
    a = score_offsets(
        S, prior, pts, valid, dthetas, offs, offs, 0.1, origin, impl="gather"
    )
    b = score_offsets(
        S, prior, pts, valid, dthetas, offs, offs, 0.1, origin, impl="mxu"
    )
    # use_bf16 defaults True — compare loosely; interior beams only differ
    # by bf16 rounding
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0.05, rtol=0.05)


def test_mxu_matches_gather_bilinear():
    S, prior, pts, valid, dthetas, offs, origin = _inputs(seed=1)
    a = score_offsets(
        S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
        bilinear=True, impl="gather",
    )
    b = score_offsets(
        S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
        bilinear=True, impl="mxu",
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0.05, rtol=0.05)


def test_mxu_f32_exact():
    from slam2d_tpu.ops.mxu_score import score_offsets_mxu

    S, prior, pts, valid, dthetas, offs, origin = _inputs(seed=2)
    a = score_offsets(
        S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
        bilinear=True, impl="gather",
    )
    # recompute positions exactly as score_offsets does
    from slam2d_tpu.core import se2

    theta = prior[2] + dthetas
    p = se2.rotate_points(theta, pts[None, :, :])
    pos_col = (p[..., 0] + prior[0] - origin[0]) / 0.1 - 0.5
    pos_row = (p[..., 1] + prior[1] - origin[1]) / 0.1 - 0.5
    b = score_offsets_mxu(
        S, pos_row, pos_col, valid, R=9, C=9, bilinear=True, use_bf16=False
    ) / jnp.maximum(valid.sum().astype(jnp.float32), 1.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)
