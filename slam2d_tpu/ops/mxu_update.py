"""Scatter-add as a one-hot matmul (the map-update analog of mxu_score;
the explicit "sparse_mxu" alternative to XLA's scatter-add).

A weighted point-splat image is exactly

    img[h, w] = sum_s v_s * onehot(h == r_s) * onehot(w == c_s)
              = (v ⊙ R1)^T @ C1,   R1 [S, H], C1 [S, W] one-hots

— one [H, S] x [S, W] contraction that also vmaps cleanly over particles.
Duplicate points accumulate exactly like scatter-add (modulo float
summation order).

Weights ride the row factor; the column factor is an exact 0/1 operand.
With use_bf16 the weights round to bf16 (f32 accumulate via
preferred_element_type); the f32 path asks for HIGHEST precision, since a
default-precision f32 matmul may run in TF32 on a GPU and round them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("H", "W", "use_bf16"))
def scatter_add_mxu(rows, cols, w, H: int, W: int, use_bf16: bool = True):
    """Dense [H, W] image accumulating w_s at (rows_s, cols_s).

    Out-of-range indices must arrive pre-masked (w = 0) and pre-clipped,
    exactly as the scatter path prepares them.
    """
    cdtype = jnp.bfloat16 if use_bf16 else jnp.float32
    precision = None if use_bf16 else jax.lax.Precision.HIGHEST
    h_iota = jnp.arange(H, dtype=jnp.int32)
    w_iota = jnp.arange(W, dtype=jnp.int32)
    R1 = (rows[:, None] == h_iota).astype(jnp.float32) * w[:, None]
    C1 = (cols[:, None] == w_iota).astype(cdtype)
    return jax.lax.dot_general(
        R1.astype(cdtype), C1,
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
