"""The gather scorer (match.correlative.score_offsets, impl="gather") vs a
NumPy per-beam patch oracle, and the one-hot-matmul scorers' window-edge
beam masking."""

import jax.numpy as jnp
import numpy as np

from slam2d_tpu.match.correlative import score_offsets
from slam2d_tpu.ops.mxu_score import score_offsets_mxu


def _oracle(S, prior, pts, valid, dthetas, offs, cell, origin):
    """Bilinear sample of S at every beam endpoint of every candidate;
    out-of-window samples read 0; mean over valid beams."""
    H, W = S.shape
    out = np.zeros((len(dthetas), len(offs), len(offs)))

    def at(r, c):
        return S[r, c] if (0 <= r < H and 0 <= c < W) else 0.0

    for t, dth in enumerate(dthetas):
        th = prior[2] + dth
        c_, s_ = np.cos(th), np.sin(th)
        for b in np.flatnonzero(valid):
            x = c_ * pts[b, 0] - s_ * pts[b, 1] + prior[0]
            y = s_ * pts[b, 0] + c_ * pts[b, 1] + prior[1]
            pc = (x - origin[0]) / cell - 0.5
            pr = (y - origin[1]) / cell - 0.5
            c0, r0 = int(np.floor(pc)), int(np.floor(pr))
            fc, fr = pc - c0, pr - r0
            for i, dr in enumerate(offs):
                for j, dc in enumerate(offs):
                    r, c = r0 + dr, c0 + dc
                    out[t, i, j] += (
                        (1 - fr) * (1 - fc) * at(r, c)
                        + (1 - fr) * fc * at(r, c + 1)
                        + fr * (1 - fc) * at(r + 1, c)
                        + fr * fc * at(r + 1, c + 1)
                    )
    return out / max(valid.sum(), 1)


def test_gather_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    S = rng.normal(size=(48, 48)).astype(np.float32)
    prior = np.array([2.0, 2.2, 0.3], np.float32)
    # some endpoints near/over the window edge exercise the per-cell mask
    pts = rng.uniform(-2.3, 2.3, (17, 2)).astype(np.float32)
    valid = rng.uniform(size=17) > 0.25
    dthetas = np.linspace(-0.1, 0.1, 3).astype(np.float32)
    offs = np.arange(-3, 4)
    origin = np.array([-0.2, -0.1], np.float32)
    got = np.asarray(
        score_offsets(
            jnp.asarray(S), jnp.asarray(prior), jnp.asarray(pts),
            jnp.asarray(valid), jnp.asarray(dthetas),
            jnp.asarray(offs, jnp.int32), jnp.asarray(offs, jnp.int32),
            0.1, jnp.asarray(origin), bilinear=True, impl="gather",
        )
    )
    want = _oracle(S, prior, pts, valid, dthetas, offs, 0.1, origin)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_edge_beams_are_masked():
    """One-hot-matmul scorers drop a beam whose (R+1)x(C+1) patch leaves
    the window, for ALL offsets."""
    H = W = 32
    R = C = 5
    S = jnp.ones((H, W), jnp.float32)
    pos_r = jnp.asarray([[1.0, 16.0, 30.5]], jnp.float32)  # first/last at edges
    pos_c = jnp.asarray([[16.0, 16.0, 16.0]], jnp.float32)
    got = np.asarray(
        score_offsets_mxu(S, pos_r, pos_c, jnp.ones(3, bool), R=R, C=C,
                          bilinear=True, use_bf16=False)
    )
    # only the middle beam contributes; bilinear weights sum to 1 on ones
    np.testing.assert_allclose(got[0], 1.0, atol=1e-5)
