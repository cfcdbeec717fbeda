"""Correlative-match scoring as one-hot matmuls (the explicit alternatives
to the gather scorer in match/correlative.py).

The scoring gather (score[t,i,j] = sum_b S[r_tb + i, c_tb + j]) is a
random-access pattern. Each (theta, beam) needs a CONTIGUOUS (R+1)x(C+1)
patch, and a patch gather is exactly two one-hot contractions:

  stage 1 (rows):  P[x, i, w] = sum_h A[x, i, h] * S[h, w]
      A = soft row one-hot — 1 at h = r_x + i (beam validity folded in)
      flattened to ONE [X*(R+1), H] @ [H, W] matmul, X = T*B
  stage 2 (cols):  Q[x, i, j] = sum_w P[x, i, w] * O[x, w, j]
      O = col one-hot — a batched [R+1, W] @ [W, C+1] matmul per x

  bilinear: blend the 4 corner views of Q with the fractional weights
  (or use the corner view alone for nearest-neighbor scoring).

~19 GFLOP per frontend match in two matmuls (optionally bf16 with f32
accumulation) instead of ~1M gathered samples. Precision: the bf16 and
int8 operand paths are exact on the one-hot factors and round only S; the
f32 path runs at the backend's default matmul precision (TF32 on recent
NVIDIA GPUs, ~3 decimal digits), so pass use_bf16=False under
jax.default_matmul_precision("highest") for a full-f32 reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit, static_argnames=("R", "C", "bilinear")
)
def score_offsets_mxu_int8(
    S,
    pos_row,
    pos_col,
    valid,
    R: int,
    C: int,
    bilinear: bool = True,
):
    """score_offsets_mxu with int8 operands end to end: the stream is
    the MATERIALIZED one-hot operands A/P/O, ~100 MB/match at frontend
    shapes, not the 1 MB search space, so int8 halves the bytes moved.

    - S quantizes to int8 with one global scale (the blurred likelihood
      field is smooth and bounded; 180-beam score sums average the
      ~0.4%-of-range rounding noise down below the peak-refinement
      quantum — ATE parity asserted in tests/test_score_impls.py).
    - A and O are one-hots — EXACTLY representable in int8.
    - Stage 1 runs int8 x int8 -> int32; its output rows are gathered S
      values, so the int8 downcast back is exact and P stays 1 byte.
    - The bilinear corner blend happens in f32 on the small [X, R+1,
      C+1] Q block, identical math to the f32/bf16 path.
    Halves every operand byte vs bf16: A 34->17 MB, P 34->17, O 34->17
    at the frontend match shape."""
    H, W = S.shape
    T, B = pos_row.shape
    X = T * B
    ra, ca = R // 2, C // 2

    r0f = jnp.floor(pos_row) if bilinear else jnp.round(pos_row)
    c0f = jnp.floor(pos_col) if bilinear else jnp.round(pos_col)
    fr = (pos_row - r0f).reshape(X) if bilinear else jnp.zeros(X, jnp.float32)
    fc = (pos_col - c0f).reshape(X) if bilinear else jnp.zeros(X, jnp.float32)
    r0 = r0f.astype(jnp.int32).reshape(X) - ra
    c0 = c0f.astype(jnp.int32).reshape(X) - ca

    ok = (
        (r0 >= 0) & (r0 <= H - (R + 1))
        & (c0 >= 0) & (c0 <= W - (C + 1))
        & jnp.tile(valid, T)
    )
    r0 = jnp.clip(r0, 0, H - (R + 1))
    c0 = jnp.clip(c0, 0, W - (C + 1))

    scale = jnp.maximum(jnp.max(jnp.abs(S)), 1e-12) / 127.0
    S8 = jnp.clip(jnp.round(S / scale), -127, 127).astype(jnp.int8)

    h_iota = jnp.arange(H, dtype=jnp.int32)
    rows_idx = r0[:, None] + jnp.arange(R + 1, dtype=jnp.int32)[None, :]
    A = (rows_idx[:, :, None] == h_iota[None, None, :]) & ok[:, None, None]
    A8 = A.reshape(X * (R + 1), H).astype(jnp.int8)
    P8 = jnp.dot(
        A8, S8, preferred_element_type=jnp.int32
    ).astype(jnp.int8)                       # exact: rows of S8 (or 0)
    P8 = P8.reshape(X, R + 1, W)

    w_iota = jnp.arange(W, dtype=jnp.int32)
    cols_idx = c0[:, None] + jnp.arange(C + 1, dtype=jnp.int32)[None, :]
    O8 = (w_iota[None, :, None] == cols_idx[:, None, :]).astype(jnp.int8)
    Q = jax.lax.dot_general(
        P8, O8,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * scale            # [X, R+1, C+1]

    if bilinear:
        w00 = ((1 - fr) * (1 - fc))[:, None, None]
        w01 = ((1 - fr) * fc)[:, None, None]
        w10 = (fr * (1 - fc))[:, None, None]
        w11 = (fr * fc)[:, None, None]
        out = (
            Q[:, :R, :C] * w00
            + Q[:, :R, 1:] * w01
            + Q[:, 1:, :C] * w10
            + Q[:, 1:, 1:] * w11
        )
    else:
        out = Q[:, :R, :C]

    return out.reshape(T, B, R, C).sum(axis=1)


@functools.partial(
    jax.jit, static_argnames=("R", "C", "bilinear", "use_bf16")
)
def score_offsets_mxu(
    S,
    pos_row,
    pos_col,
    valid,
    R: int,
    C: int,
    bilinear: bool = True,
    use_bf16: bool = True,
):
    """Scores [T, R, C]: sum over beams of (bi)linear samples of S at
    (pos_row + i - R//2, pos_col + j - C//2).

    Args:
      S: [H, W] float32 search-space window.
      pos_row / pos_col: [T, B] fractional cell-center endpoint coordinates.
      valid: [B] bool beam validity.

    Boundary semantics: a beam whose full (R+1)x(C+1) patch leaves the
    window is dropped for ALL offsets (the gather impl instead masks
    per-cell) — scores can differ slightly at window edges between impls;
    window sizing keeps endpoints interior on the hot paths.
    """
    H, W = S.shape
    T, B = pos_row.shape
    X = T * B
    ra, ca = R // 2, C // 2

    r0f = jnp.floor(pos_row) if bilinear else jnp.round(pos_row)
    c0f = jnp.floor(pos_col) if bilinear else jnp.round(pos_col)
    fr = (pos_row - r0f).reshape(X) if bilinear else jnp.zeros(X, jnp.float32)
    fc = (pos_col - c0f).reshape(X) if bilinear else jnp.zeros(X, jnp.float32)
    r0 = r0f.astype(jnp.int32).reshape(X) - ra
    c0 = c0f.astype(jnp.int32).reshape(X) - ca

    ok = (
        (r0 >= 0) & (r0 <= H - (R + 1))
        & (c0 >= 0) & (c0 <= W - (C + 1))
        & jnp.tile(valid, T)
    )
    r0 = jnp.clip(r0, 0, H - (R + 1))
    c0 = jnp.clip(c0, 0, W - (C + 1))

    cdtype = jnp.bfloat16 if use_bf16 else jnp.float32

    # stage 1: row extraction as one big matmul
    h_iota = jnp.arange(H, dtype=jnp.int32)
    rows_idx = r0[:, None] + jnp.arange(R + 1, dtype=jnp.int32)[None, :]
    A = (rows_idx[:, :, None] == h_iota[None, None, :]) & ok[:, None, None]
    A = A.reshape(X * (R + 1), H).astype(cdtype)
    P = jnp.dot(A, S.astype(cdtype), preferred_element_type=jnp.float32)
    P = P.reshape(X, R + 1, W).astype(cdtype)

    # stage 2: column extraction as a batched matmul
    w_iota = jnp.arange(W, dtype=jnp.int32)
    cols_idx = c0[:, None] + jnp.arange(C + 1, dtype=jnp.int32)[None, :]
    O = (w_iota[None, :, None] == cols_idx[:, None, :]).astype(cdtype)
    Q = jax.lax.dot_general(
        P, O,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [X, R+1, C+1]

    if bilinear:
        w00 = ((1 - fr) * (1 - fc))[:, None, None]
        w01 = ((1 - fr) * fc)[:, None, None]
        w10 = (fr * (1 - fc))[:, None, None]
        w11 = (fr * fc)[:, None, None]
        out = (
            Q[:, :R, :C] * w00
            + Q[:, :R, 1:] * w01
            + Q[:, 1:, :C] * w10
            + Q[:, 1:, 1:] * w11
        )
    else:
        out = Q[:, :R, :C]

    return out.reshape(T, B, R, C).sum(axis=1)


def _endpoint_splat(H, W, r0, c0, fr, fc, ok, cdtype):
    """Beam-endpoint splat image E [T, H, W]: the bilinear 4-corner splat of
    every valid endpoint, as one [H, B] @ [B, W] matmul per theta (soft
    one-hot outer product). The validity mask rides on the row factor only
    (the outer product then zeroes the whole beam)."""
    h_iota = jnp.arange(H, dtype=jnp.int32)
    w_iota = jnp.arange(W, dtype=jnp.int32)
    okf = ok.astype(jnp.float32)
    R1 = (
        (r0[:, :, None] == h_iota) * ((1.0 - fr) * okf)[:, :, None]
        + ((r0 + 1)[:, :, None] == h_iota) * (fr * okf)[:, :, None]
    ).astype(cdtype)                                     # [T, B, H]
    C1 = (
        (c0[:, :, None] == w_iota) * (1.0 - fc)[:, :, None]
        + ((c0 + 1)[:, :, None] == w_iota) * fc[:, :, None]
    ).astype(cdtype)                                     # [T, B, W]
    return jax.lax.dot_general(
        R1, C1,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(cdtype)                                     # [T, H, W]


def _splat_inputs(S_shape, pos_row, pos_col, valid, R, C, bilinear):
    """Endpoint->corner/validity prep for the emx scorer and the shared
    PF refinement (boundary semantics of score_offsets_mxu: a beam whose
    (R+1)x(C+1) patch leaves the window is dropped for ALL offsets)."""
    H, W = S_shape
    ra, ca = R // 2, C // 2
    r0f = jnp.floor(pos_row) if bilinear else jnp.round(pos_row)
    c0f = jnp.floor(pos_col) if bilinear else jnp.round(pos_col)
    fr = pos_row - r0f if bilinear else jnp.zeros_like(pos_row)
    fc = pos_col - c0f if bilinear else jnp.zeros_like(pos_col)
    r0 = r0f.astype(jnp.int32) - ra
    c0 = c0f.astype(jnp.int32) - ca
    ok = (
        (r0 >= 0) & (r0 <= H - (R + 1))
        & (c0 >= 0) & (c0 <= W - (C + 1))
        & valid[None, :]
    )
    r0 = jnp.clip(r0, 0, H - (R + 1))
    c0 = jnp.clip(c0, 0, W - (C + 1))
    return r0, c0, fr, fc, ok


@functools.partial(
    jax.jit, static_argnames=("R", "C", "bilinear", "use_bf16")
)
def score_offsets_emx(
    S,
    pos_row,
    pos_col,
    valid,
    R: int,
    C: int,
    bilinear: bool = True,
    use_bf16: bool = True,
):
    """Endpoint-image formulation of score_offsets_mxu — same contract,
    same boundary semantics, different (faster) matmul shapes.

    The patch-extraction form's stage 2 is a batched [R+1, W] x [W, C+1]
    matmul per (theta, beam) with M = N ~ 10, far too small to fill a
    matrix unit. This form instead notes that the score over ALL offsets
    is a cross-correlation with the beam-endpoint splat image:

      E_t = R1_t^T @ C1_t          (soft one-hot outer product: the
                                    bilinear 4-corner splat of every
                                    endpoint, one [H, B] @ [B, W] matmul)
      score[t, dr, dc] = <E_t, S shifted by (dr, dc)>
                       = ([T, H*W] @ [H*W, R*C])[t, (dr, dc)]

    against R*C statically-shifted copies of S — both matmuls have large
    contraction dims (B=180 / H*W=83k), and the only materialized
    intermediates are E ([T, H, W]) and the shift stack ([R*C, H, W]).

    Boundary semantics match score_offsets_mxu: a beam whose (R+1)x(C+1)
    patch leaves the window is dropped for ALL offsets.
    """
    H, W = S.shape
    T, B = pos_row.shape
    r0, c0, fr, fc, ok = _splat_inputs((H, W), pos_row, pos_col, valid, R, C, bilinear)
    cdtype = jnp.bfloat16 if use_bf16 else jnp.float32
    E = _endpoint_splat(H, W, r0, c0, fr, fc, ok, cdtype)

    # shift stack: S2[dr*C + dc] = S shifted by (dr, dc), zero-padded —
    # in-bounds beams never read the padding (their patch is interior)
    Sp = jnp.pad(S.astype(cdtype), ((0, R), (0, C)))
    S2 = jnp.stack(
        [Sp[dr : dr + H, dc : dc + W] for dr in range(R) for dc in range(C)]
    )                                                    # [R*C, H, W]

    out = jax.lax.dot_general(
        E.reshape(T, H * W), S2.reshape(R * C, H * W),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                    # [T, R*C]
    return out.reshape(T, R, C)
