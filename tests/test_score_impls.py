"""All scoring kernels agree (gather / mxu / emx / mxu_int8)."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam2d_tpu.match.correlative import score_offsets


def _inputs(seed=3, T=3, B=24, H=96, W=96):
    rng = np.random.default_rng(seed)
    S = jnp.asarray(rng.normal(size=(H, W)).astype(np.float32))
    prior = jnp.asarray([2.0, 2.2, 0.3], jnp.float32)
    pts = jnp.asarray(rng.uniform(-1.5, 1.5, (B, 2)).astype(np.float32))
    valid = jnp.asarray(rng.uniform(size=B) > 0.2)
    dthetas = jnp.asarray(np.linspace(-0.15, 0.15, T), jnp.float32)
    offs = jnp.arange(-3, 4, dtype=jnp.int32)
    origin = jnp.asarray([-2.0, -2.0], jnp.float32)
    return S, prior, pts, valid, dthetas, offs, origin


@pytest.mark.parametrize("bilinear", [False, True])
def test_three_impls_agree(bilinear):
    S, prior, pts, valid, dthetas, offs, origin = _inputs()
    out = {}
    for impl in ("gather", "mxu", "emx"):
        out[impl] = np.asarray(
            score_offsets(
                S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
                bilinear=bilinear, impl=impl, use_bf16=False,
            )
        )
    np.testing.assert_allclose(out["mxu"], out["gather"], atol=2e-4)
    np.testing.assert_allclose(out["emx"], out["mxu"], atol=2e-4)


@pytest.mark.parametrize("bilinear", [False, True])
def test_int8_impl_tracks_f32(bilinear):
    """mxu_int8 (int8 operands halve the scorer's memory stream) ==
    gather within the int8 quantization quantum: one global scale on S,
    one-hot operands exact, so per-sample error <= scale/2 and
    mean-over-beams error well below it."""
    S, prior, pts, valid, dthetas, offs, origin = _inputs()
    ref = np.asarray(
        score_offsets(
            S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
            bilinear=bilinear, impl="gather", use_bf16=False,
        )
    )
    q = np.asarray(
        score_offsets(
            S, prior, pts, valid, dthetas, offs, offs, 0.1, origin,
            bilinear=bilinear, impl="mxu_int8",
        )
    )
    scale = float(np.abs(np.asarray(S)).max()) / 127.0
    np.testing.assert_allclose(q, ref, atol=scale)
    # and the argmax candidate (what the matcher consumes) agrees
    assert np.unravel_index(q.argmax(), q.shape) == np.unravel_index(
        ref.argmax(), ref.shape
    )


def test_int8_impl_end_to_end_ate():
    """Frontend ATE parity with score_impl='mxu_int8' on a short synthetic
    log (the int8 path must not perturb tracking)."""
    import dataclasses

    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, SensorConfig,
    )
    from slam2d_tpu.data.synth import SynthWorld, simulate_log
    from slam2d_tpu.metrics import ate_rmse
    from slam2d_tpu.run.frontend import run_frontend

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=120, max_range=12.0),
        grid=GridConfig(height=256, width=256, resolution=0.1,
                        ray_samples=128, center_x=10.0, center_y=10.0),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=16,
    )
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5]])
    log = simulate_log(world, wp, cfg.sensor, step=0.15,
                       odom_noise_xy=0.015, odom_noise_theta=0.006, seed=13)
    gt = log["gt_poses"]
    _, tr_f32, _ = run_frontend(log, cfg)
    cfg8 = dataclasses.replace(
        cfg, matcher=dataclasses.replace(cfg.matcher, score_impl="mxu_int8")
    )
    _, tr_i8, _ = run_frontend(log, cfg8)
    a32 = float(ate_rmse(tr_f32, gt, align=False))
    a8 = float(ate_rmse(tr_i8, gt, align=False))
    assert a8 < max(1.2 * a32, a32 + 0.03), (a8, a32)
