"""The search-space blur (match.correlative._separable_blur) vs a NumPy
zero-padded separable convolution."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam2d_tpu.match.correlative import _gaussian_kernel_1d, _separable_blur


def _np_blur(img, k):
    img = np.asarray(img, np.float64)
    rows = np.stack([np.convolve(c, k, "same") for c in img.T], axis=1)
    return np.stack([np.convolve(r, k, "same") for r in rows])


@pytest.mark.parametrize(
    "shape,sigma,hw", [((96, 160), 1.0, 4), ((72, 136), 1.5, 5)]
)
def test_matches_numpy_blur_vmapped(shape, sigma, hw):
    rng = np.random.default_rng(hw)
    imgs = rng.normal(0, 1, (3, *shape)).astype(np.float32)
    k = _gaussian_kernel_1d(sigma, hw)
    got = np.asarray(jax.vmap(lambda x: _separable_blur(x, k))(jnp.asarray(imgs)))
    for i in range(3):
        np.testing.assert_allclose(got[i], _np_blur(imgs[i], k), atol=1e-5)

