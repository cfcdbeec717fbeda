"""Copies that must be bit-exact in every dtype: the resample row copy
(pf.fastslam._resample_copy), the sharded ring hop's map migration, and
the shared update's slot select. On a GPU an f32 one-hot matmul may run
in TF32 and round, so each is a gather, and these tests pin exactness."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam2d_tpu.pf.fastslam import _resample_copy


@pytest.mark.parametrize(
    "P,shape", [(16, (16, 32, 128)), (8, (8, 96, 288)), (12, (12, 1000))]
)
def test_resample_copy_matches_numpy(P, shape):
    rng = np.random.default_rng(P)
    # values that f32 keeps but TF32/bf16 would round
    x = (rng.normal(size=shape) * np.pi).astype(np.float32)
    anc = rng.integers(0, P, P)
    got = np.asarray(_resample_copy(jnp.asarray(x), jnp.asarray(anc, jnp.int32)))
    np.testing.assert_array_equal(got, x[anc])


def test_resample_copy_bf16_identity_and_duplicates():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(8, 64, 128)).astype(np.float32)).astype(
        jnp.bfloat16
    )
    ident = jnp.arange(8, dtype=jnp.int32)
    got = _resample_copy(x, ident)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got, np.float32), np.asarray(x, np.float32)
    )
    # duplicated ancestors (weight collapse): every row = row 3
    got = np.asarray(_resample_copy(x, jnp.full((8,), 3, jnp.int32)), np.float32)
    np.testing.assert_array_equal(
        got, np.tile(np.asarray(x, np.float32)[3][None], (8, 1, 1))
    )


def test_sharded_ring_hop_is_bit_exact():
    """Force a resample on 8 virtual devices with f32 maps holding
    non-TF32-representable values: every particle's map after the ring
    exchange equals its ancestor's map bit for bit."""
    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
    )
    from slam2d_tpu.parallel.mesh import make_particle_mesh
    from slam2d_tpu.pf.sharded import make_sharded_step, sharded_fastslam_init
    from slam2d_tpu.pf.fastslam import systematic_ancestors

    n = 8
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=16, max_range=4.0),
        grid=GridConfig(height=32, width=32, resolution=0.1, ray_samples=16,
                        center_x=1.6, center_y=1.6),
        matcher=MatcherConfig(search_xy=0.1, search_theta=0.05, n_theta=3),
        bootstrap_dist=0.0, match_min_motion=0.0,
        map_update_min_motion=1e9,
    )
    pf = PFConfig(n_particles=2 * n, resample_threshold=2.0)
    mesh = make_particle_mesh(n)
    state = sharded_fastslam_init(cfg, pf, jax.random.PRNGKey(0), mesh)
    rng = np.random.default_rng(0)
    maps = (rng.normal(size=(2 * n, 32, 32)) * np.pi).astype(np.float32)
    # skewed weights so the ancestors cross shard boundaries
    log_w = np.linspace(-6.0, 0.0, 2 * n).astype(np.float32)
    from slam2d_tpu.pf.sharded import place_state

    state = place_state(
        state._replace(logodds=maps, log_w=log_w,
                       since_update=np.float32(0.0)),
        mesh,
    )
    step = jax.jit(make_sharded_step(cfg, pf, mesh, ring_stats=True))
    odom = jnp.zeros(3, jnp.float32)
    ranges = jnp.full((16,), 100.0, jnp.float32)   # no hits: score 0 everywhere
    new, (_, n_eff, _, k_need) = step(state, odom, ranges)
    out = np.asarray(new.logodds)
    # the weights the step resampled on: scores are identical for every
    # particle, so normalization leaves the ancestors of log_w unchanged
    u = jax.random.uniform(
        jax.random.fold_in(jax.random.split(state.rng)[1], 10_000_019)
    )
    anc = np.asarray(systematic_ancestors(jnp.asarray(log_w), u))
    assert np.asarray(k_need).max() >= 1          # rows crossed shards
    np.testing.assert_array_equal(out, maps[anc])


def test_shared_update_slot_select_is_bit_exact():
    """The shared update's per-particle image select is a row gather: with
    the map add and clamp made identities (huge clamp, one particle per
    slot image), the written window equals the selected image exactly."""
    from slam2d_tpu.pf.shared_update import apply_images

    rng = np.random.default_rng(2)
    G, P, win = 5, 9, 32
    images = jnp.asarray((rng.normal(size=(G, win, win)) * np.pi)
                         .astype(np.float32))
    slot = jnp.asarray(rng.integers(0, G, P), jnp.int32)
    imgs_p = jnp.take(images, slot, axis=0)
    maps = jnp.zeros((P, 64, 64), jnp.float32)
    anchors = jnp.full((P, 2), 32, jnp.int32)
    out = np.asarray(apply_images(maps, anchors, imgs_p, win, 1e30))
    np.testing.assert_array_equal(
        out[:, 16:48, 16:48], np.asarray(images)[np.asarray(slot)]
    )


@pytest.mark.gpu
def test_f32_copies_exact_on_gpu(gpu):
    """On the card, where a default-precision f32 matmul runs in TF32:
    the resample copy and the slot select stay bit-exact."""
    from slam2d_tpu.pf.shared_update import apply_images

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(64, 256, 256)) * np.pi).astype(np.float32)
    anc = rng.integers(0, 64, 64)
    got = jax.jit(_resample_copy)(jnp.asarray(x), jnp.asarray(anc, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got), x[anc])
    images = (rng.normal(size=(4, 32, 32)) * np.pi).astype(np.float32)
    slot = rng.integers(0, 4, 64)
    out = apply_images(jnp.zeros((64, 64, 64), jnp.float32),
                       jnp.full((64, 2), 32, jnp.int32),
                       jnp.take(jnp.asarray(images), jnp.asarray(slot), axis=0),
                       32, 1e30)
    np.testing.assert_array_equal(np.asarray(out)[:, 16:48, 16:48],
                                  images[slot])
