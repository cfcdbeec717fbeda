"""Shared-anchor batched PF refinement: one matmul for all particles.

The per-particle refinement path (pf/fastslam.py refine_branch with
refine_mode="per_particle") vmaps match_scan over particles, so every
particle builds its own endpoint-splat images and scores them against its
own search window — small [T, H*W] x [H*W, R*C] products (M=9, N=25),
repeated P times.

This module exploits what the vmap cannot: the SCAN is common to all
particles. If every particle's candidate set is anchored on the map cell
lattice (candidates = the prior's CELL CENTER plus integer cell offsets)
and rotation candidates live on one GLOBAL theta grid, then the endpoint
splat image E depends only on (scan, theta) — shared — and all particles
score through a single matmul:

    scores[p, (g, dr, dc)] = <Sp_p, shift_{dr,dc}(E_g)>
                           = (Sp [P, K] @ stack [G*R*C, K]^T)  (K ~ 86k)

with M = P and N = G*R*C both large. The per-particle work that
remains is window extraction + blur (bandwidth) and tiny [P, G, R, C]
selection math.

Semantics vs the per-particle path (both intentional, ATE-validated):
- Candidate translations are anchored at the prior's cell center rather
  than the prior itself (a <= half-cell shift of the search lattice; the
  quadratic sub-cell peak interpolation recovers the remainder, and the
  motion prior uses exact candidate-to-prior distances).
- Rotation candidates come from a global grid of G = n_theta +
  2*refine_theta_pad slots centered on the particles' circular-mean
  heading, instead of each particle's own heading; candidates farther
  than the particle's own search_theta (+half step) are masked out. A
  particle's effective theta lattice is thus offset from its prior by up
  to half a step (sub-bin interpolation recovers it), and particles
  whose heading drifted beyond the pad slots search a clipped range.

Reference anchor: this replaces the per-particle correlative refinement
of FastSLAM's proposal (SURVEY.md §4.3 step 2) — same search box, same
scoring field, restructured as one large matrix product.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam2d_tpu.config import FrontendConfig, MatcherConfig, PFConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import (
    cell_center_world,
    scan_endpoints_local,
    world_to_cell,
)
from slam2d_tpu.grid.window import extract_window, scan_window_cells
from slam2d_tpu.match.correlative import build_search_space
from slam2d_tpu.ops.mxu_score import _endpoint_splat, _splat_inputs


def _global_theta_grid(mcfg: MatcherConfig, pad: int):
    """(G, step): n_theta + 2*pad slots at the matcher's theta step."""
    if mcfg.n_theta <= 1:
        return 1 + 2 * pad, 0.0
    step = 2.0 * mcfg.search_theta / (mcfg.n_theta - 1)
    return mcfg.n_theta + 2 * pad, step


def aligned_window(grid, prior, gcfg, win: int):
    """Extract the win x win window whose CENTER cell is the prior's cell,
    even at map edges. extract_window clamps there, so the clamped
    extraction is rolled back into the unclamped frame and the rolled-in
    out-of-map cells are zeroed (log-odds 0 == unknown, their true state).
    Returns (window, anchor world-xy = the prior's cell center)."""
    center = world_to_cell(prior[:2], gcfg)
    gw, (r0w, c0w) = extract_window(grid, center, win)
    dr_ = (center[0] - win // 2) - r0w
    dc_ = (center[1] - win // 2) - c0w
    gw = jnp.roll(gw, (-dr_, -dc_), axis=(0, 1))
    i = jnp.arange(win, dtype=jnp.int32)
    rmask = (i + dr_ >= 0) & (i + dr_ < win)
    cmask = (i + dc_ >= 0) & (i + dc_ < win)
    gw = gw * (rmask[:, None] & cmask[None, :]).astype(gw.dtype)
    return gw, cell_center_world(center, gcfg)


def shift_stack(E, R: int, C: int):
    """[G, R*C, win, win]: stack[g, dr*C+dc][h, w] = E[g, h-dr, w-dc],
    zero where the shift runs off the low edge (the unpadded window
    frame of endpoint_shift_stack)."""
    win_r, win_c = E.shape[1], E.shape[2]
    return jnp.stack(
        [
            jnp.pad(E, ((0, 0), (dr, 0), (dc, 0)))[:, :win_r, :win_c]
            for dr in range(R)
            for dc in range(C)
        ],
        axis=1,
    )


def endpoint_shift_stack(ranges, sensor, thetas, win: int, R: int, C: int,
                         res: float, cdtype):
    """The scan-shared scorer weights: endpoint-splat images for every
    theta in `thetas`, expanded to all (dr, dc) lags and flattened. The
    stack lives in the UNPADDED window frame (shift_stack), so

        <stack[g, l], S> == <E_g, pad(S)[dr:dr+win, dc:dc+win]>

    i.e. exactly emx's lag semantics with NO padding of S."""
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    pts = se2.rotate_points(thetas, pts_local[None, :, :])    # [G, B, 2]
    # anchor sits exactly at the window's center cell CENTER, so its
    # cell-center coordinate is the integer win//2 for every particle
    # (window origins are lattice-aligned) — this is what makes E shared
    pos_col = jnp.where(valid[None, :], pts[..., 0] / res + win // 2, 0.0)
    pos_row = jnp.where(valid[None, :], pts[..., 1] / res + win // 2, 0.0)
    r0, c0, fr, fc, ok = _splat_inputs(
        (win, win), pos_row, pos_col, valid, R, C, bilinear=True
    )
    E = _endpoint_splat(win, win, r0, c0, fr, fc, ok, cdtype)
    stack = shift_stack(E, R, C)                     # [G, R*C, win, win]
    return stack.reshape(thetas.shape[0] * R * C, win * win)


def shared_refine(
    grids,
    ranges,
    priors,
    cfg: FrontendConfig,
    mcfg: MatcherConfig,
    pf: PFConfig,
):
    """Batched refinement of all particles against their own maps.

    Args:
      grids: [P, Hm, Wm] per-particle log-odds maps.
      ranges: [B] shared scan.
      priors: [P, 3] noisy odometry proposals.
    Returns:
      (poses [P, 3], scores [P]) — per-particle refined pose (prior kept
      where the best raw score is below mcfg.min_score) and the raw field
      score at the chosen candidate (the likelihood-field weight input).
    """
    gcfg = cfg.grid
    res = gcfg.resolution
    P = grids.shape[0]
    win = scan_window_cells(gcfg, cfg.sensor, mcfg)
    r_fine = int(round(mcfg.search_xy / res))
    R = C = 2 * r_fine + 1
    ra = ca = r_fine
    G, dth_step = _global_theta_grid(mcfg, pf.refine_theta_pad)
    cdtype = jnp.bfloat16 if mcfg.score_bf16 else jnp.float32

    _, valid = scan_endpoints_local(ranges, cfg.sensor)
    denom = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)

    # --- shared endpoint-splat shift stack (scan x global theta grid) ------
    theta_ref = jnp.arctan2(
        jnp.mean(jnp.sin(priors[:, 2])), jnp.mean(jnp.cos(priors[:, 2]))
    )
    dthg = (
        jnp.arange(G, dtype=jnp.float32) - (G - 1) / 2.0
    ) * jnp.float32(dth_step)
    thetas = theta_ref + dthg                                  # [G]
    chunked = bool(pf.refine_chunk) and P > pf.refine_chunk
    if chunked:
        assert P % pf.refine_chunk == 0, (P, pf.refine_chunk)

    K = win * win
    stack_flat = endpoint_shift_stack(
        ranges, cfg.sensor, thetas, win, R, C, res, cdtype
    )

    def chunk_scores(args):
        grids_c, priors_c = args

        def one(grid, prior):
            gw, anchor_xy = aligned_window(grid, prior, gcfg, win)
            S = build_search_space(gw, mcfg, res)
            return S.astype(cdtype).reshape(K), anchor_xy

        Sp_flat, anchor_xy = jax.vmap(one)(grids_c, priors_c)
        raw = (
            jax.lax.dot_general(
                Sp_flat, stack_flat,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            / denom
        )                                                  # [chunk, G*R*C]
        return raw, anchor_xy

    if chunked:
        nc = P // pf.refine_chunk
        raw, anchor_xy = jax.lax.map(
            chunk_scores,
            (
                grids.reshape(nc, pf.refine_chunk, *grids.shape[1:]),
                priors.reshape(nc, pf.refine_chunk, 3),
            ),
        )
        raw = raw.reshape(P, G * R * C)
        anchor_xy = anchor_xy.reshape(P, 2)
    else:
        raw, anchor_xy = chunk_scores((grids, priors))
    raw = raw.reshape(P, G, R, C)

    # --- motion prior + per-particle theta-range mask -----------------------
    off_r = (jnp.arange(R, dtype=jnp.float32) - ra) * res       # [R] (dy)
    off_c = (jnp.arange(C, dtype=jnp.float32) - ca) * res       # [C] (dx)
    dx = anchor_xy[:, 0:1] + off_c[None, :] - priors[:, 0:1]    # [P, C]
    dy = anchor_xy[:, 1:2] + off_r[None, :] - priors[:, 1:2]    # [P, R]
    dth = se2.wrap_angle(thetas[None, :] - priors[:, 2:3])      # [P, G]
    pen = (
        mcfg.prior_theta_weight * (dth**2)[:, :, None, None]
        + mcfg.prior_xy_weight * (dy**2)[:, None, :, None]
        + mcfg.prior_xy_weight * (dx**2)[:, None, None, :]
    )
    in_range = jnp.abs(dth) <= mcfg.search_theta + 0.5 * dth_step + 1e-6
    sf = raw - pen - jnp.where(in_range, 0.0, 1e9)[:, :, None, None]

    # --- argmax + quadratic sub-cell/sub-bin peak (match_scan semantics) ---
    flat_idx = jnp.argmax(sf.reshape(P, -1), axis=1)
    gi, ri, ci = jnp.unravel_index(flat_idx, (G, R, C))
    p_idx = jnp.arange(P)
    best_raw = raw[p_idx, gi, ri, ci]

    def subpeak(sf, axis_idx, along):
        n = sf.shape[along + 1]                     # +1: particle axis first
        i0 = jnp.clip(axis_idx, 1, n - 2)
        idx = [gi, ri, ci]

        def at(shift):
            sl = list(idx)
            sl[along] = i0 + shift
            return sf[p_idx, sl[0], sl[1], sl[2]]

        vm, v0, vp = at(-1), at(0), at(1)
        den = vm - 2.0 * v0 + vp
        d = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
        d = jnp.clip(d, -0.5, 0.5)
        # borders AND -1e9-masked theta neighbors invalidate the quadratic
        ok = (axis_idx >= 1) & (axis_idx <= n - 2) & (vm > -1e8) & (vp > -1e8)
        return jnp.where(ok, d, 0.0)

    sub_t = subpeak(sf, gi, 0) * jnp.float32(dth_step)
    sub_r = subpeak(sf, ri, 1) * res
    sub_c = subpeak(sf, ci, 2) * res

    poses = jnp.stack(
        [
            anchor_xy[:, 0] + (ci.astype(jnp.float32) - ca) * res + sub_c,
            anchor_xy[:, 1] + (ri.astype(jnp.float32) - ra) * res + sub_r,
            se2.wrap_angle(thetas[gi] + sub_t),
        ],
        axis=1,
    )
    # keep the prior when the best raw score is weak OR when the chosen
    # slot is outside the particle's own theta range (a heading that
    # drifted past every padded slot masks ALL candidates to -1e9; the
    # argmax then lands on an out-of-range slot and must not be trusted —
    # per_particle mode never leaves the particle's search box)
    keep = (best_raw >= mcfg.min_score) & in_range[p_idx, gi]
    poses = jnp.where(keep[:, None], poses, priors)
    return poses, best_raw
