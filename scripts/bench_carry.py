"""Isolate the FastSLAM-1000 per-scan CARRY overhead (the cost
bench_pf1000_parts measures with every stage gated off).

Hypothesis: the two lax.cond joins whose branches return the full
[P, H, W] map stack (update gate, resample gate) each force a full-stack
copy on the identity path — ~0.66 GB of memory traffic per join at
P=1000 bf16 512^2. Variants:

  carry_only — lax.scan carrying the untouched stack + small state
  one_cond   — + one never-firing cond returning the stack
  two_conds  — + a second one (the real step's structure)

Run (from the repo root): PYTHONPATH=. python scripts/bench_carry.py
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

P, H, W = 1000, 512, 512
K = 32


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("n_conds",))
def chunk(carry, odom, n_conds: int):
    maps, poses, acc = carry

    def body(c, o):
        m, p, a = c
        p = p + o[None, :] * 1e-3
        pred = jnp.sum(o) > 1e9          # never fires, but traced
        if n_conds >= 1:
            m = jax.lax.cond(pred, lambda x: x + 1.0, lambda x: x, m)
        if n_conds >= 2:
            m, p = jax.lax.cond(
                pred, lambda t: (t[0] + 1.0, t[1] * 2.0), lambda t: t, (m, p)
            )
        return (m, p, a + jnp.sum(p)), p[0]

    carry, out = jax.lax.scan(body, (maps, poses, acc), odom)
    return carry, out


def bench(n_conds, iters=8):
    maps = jnp.zeros((P, H, W), jnp.bfloat16)
    poses = jnp.zeros((P, 3), jnp.float32)
    carry = (maps, poses, jnp.float32(0.0))
    odom = jnp.ones((K, 3), jnp.float32)
    carry, out = chunk(carry, odom, n_conds)
    np.asarray(out[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, out = chunk(carry, odom, n_conds)
    np.asarray(out[0])
    dt = (time.perf_counter() - t0) / (iters * K)
    print(json.dumps({
        "variant": ["carry_only", "one_cond", "two_conds"][n_conds],
        "ms_per_scan": round(dt * 1e3, 3),
    }), flush=True)


if __name__ == "__main__":
    for n in (0, 1, 2):
        bench(n)
