"""The shared PF refinement's lag stack (pf.shared_refine.shift_stack):
pure data movement, so it must equal a NumPy shift bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam2d_tpu.pf.shared_refine import shift_stack


def _np_stack(E, R, C):
    E = np.asarray(E)
    G, H, W = E.shape
    out = np.zeros((G, R * C, H, W), E.dtype)
    for dr in range(R):
        for dc in range(C):
            out[:, dr * C + dc, dr:, dc:] = E[:, : H - dr, : W - dc]
    return out


@pytest.mark.parametrize(
    "G,win,R,C,dtype",
    [
        (3, 64, 5, 5, jnp.float32),
        (2, 48, 3, 7, jnp.bfloat16),    # asymmetric lags, bf16
        (1, 65, 3, 3, jnp.float32),     # odd window
    ],
)
def test_stack_matches_numpy_shift(G, win, R, C, dtype):
    rng = np.random.default_rng(win)
    E = jnp.asarray(rng.normal(size=(G, win, win)).astype(np.float32)).astype(
        dtype
    )
    got = shift_stack(E, R, C)
    assert got.dtype == dtype and got.shape == (G, R * C, win, win)
    np.testing.assert_array_equal(
        np.asarray(got, np.float32), _np_stack(np.asarray(E, np.float32), R, C)
    )
