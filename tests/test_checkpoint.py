"""utils.checkpoint: npz round trip of a pytree with f32, bf16, int and
PRNG-key leaves, and a structure check against the template."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam2d_tpu.utils.checkpoint import load_state, save_state


def test_npz_round_trip_is_exact(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "maps": jnp.asarray(rng.normal(size=(3, 8, 8)), jnp.bfloat16),
        "poses": jnp.asarray(rng.normal(size=(3, 3)), jnp.float32),
        "count": np.int32(7),
        "key": jax.random.PRNGKey(3),
        "nested": (jnp.arange(5), np.float32(0.25)),
    }
    path = save_state(str(tmp_path / "ck"), state)
    back = load_state(path, jax.tree.map(np.zeros_like, state))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(np.asarray(b), a)


def test_structure_mismatch_raises(tmp_path):
    path = save_state(str(tmp_path / "ck"), {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        load_state(path, {"b": np.zeros(2)})
    with pytest.raises(ValueError, match="leaf 0"):
        load_state(path, {"a": np.zeros(3)})
