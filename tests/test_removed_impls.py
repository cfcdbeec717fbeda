"""Kernel options whose implementations were removed raise a ValueError
naming the valid values — never a silent fallback."""

import dataclasses

import jax.numpy as jnp
import pytest

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.grid.occupancy import integrate_scan
from slam2d_tpu.match.correlative import build_search_space, score_offsets


def _score(impl):
    z = jnp.zeros((16, 16))
    offs = jnp.arange(-1, 2, dtype=jnp.int32)
    score_offsets(z, jnp.zeros(3), jnp.zeros((4, 2)), jnp.ones(4, bool),
                  jnp.zeros(1), offs, offs, 0.1, jnp.zeros(2), impl=impl)


def _update(impl):
    g = dataclasses.replace(GridConfig(height=16, width=16), update_impl=impl)
    integrate_scan(jnp.zeros((16, 16)), jnp.zeros(3), jnp.ones(8), g,
                   SensorConfig(n_beams=8))


def _blur(impl):
    build_search_space(jnp.zeros((16, 16)), MatcherConfig(), 0.1,
                       blur_impl=impl)


@pytest.mark.parametrize(
    "call,value,valid",
    [
        (_score, "pallas", "gather"),
        (_score, "cmx", "emx"),
        (_update, "pallas", "sparse"),
        (_update, "pallas_ray", "sparse"),
        (_update, "pallas_hybrid", "dense"),
        (_blur, "pallas", "xla"),
    ],
)
def test_removed_value_raises(call, value, valid):
    with pytest.raises(ValueError, match=valid):
        call(value)
