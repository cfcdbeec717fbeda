"""Correlative scan matching over multi-resolution grids (SURVEY.md §4.1, L2).

The reference does a triple Python loop (theta, dx, dy) of per-beam map
lookups against a Gaussian-smeared occupancy image. Array formulation:

- the "search space" S is a likelihood field: occupied mask blurred with a
  peak-normalized Gaussian (two separable 1-D convolutions — XLA fuses these
  and they are trivially cheap next to the scoring gather),
- the coarse level is a max-pool of S ("conservative" coarse grid in the
  Olson-2009 sense: coarse scores upper-bound fine scores),
- candidate scoring is ONE dense gather: endpoint cells for every
  (theta, drow, dcol) candidate are materialized as a [T, R, C, B] index
  tensor and S is gathered once — no data-dependent control flow, fully
  vmappable over particles.

All window sizes are static (derived from MatcherConfig), so the same jitted
code serves frontend tracking, per-particle refinement, and wide-window loop
closure scoring.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import occupancy_prob, scan_endpoints_local


def _gaussian_kernel_1d(sigma: float, halfwidth: int) -> np.ndarray:
    x = np.arange(-halfwidth, halfwidth + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.max()).astype(np.float32)  # peak-normalized: S in [0, 1]


def build_search_space(
    logodds, mcfg: MatcherConfig, resolution: float, blur_impl: str = "xla"
):
    """Blurred occupied-cell likelihood field, same shape as the grid.

    Beyond the reference's Gaussian smear of occupied cells, known-FREE cells
    contribute a negative term: an endpoint hypothesis that lands where the
    map says "observed empty" is evidence against that pose (this is the
    range information an endpoint-only likelihood field throws away, and it
    kills the scan-to-scan "bead coincidence" attractor that otherwise drags
    incremental matching backward along corridors). The penalty fades where
    the occupied blur is strong so the skirt just in front of a wall — where
    legitimate sensor noise lands — is not punished.

    Output range: [-free_penalty, 1].
    """
    p = occupancy_prob(logodds)
    # Evidence weighting: a cell observed occupied once (log-odds ~l_occ)
    # counts less than an established wall. This dilutes the newest scan's
    # contribution relative to accumulated structure.
    occ = jnp.clip(logodds / mcfg.occ_evidence_sat, 0.0, 1.0)
    # halfwidth MUST match grid.window.blur_halo_cells — the cached-field
    # writeback trims exactly that halo as "blur-exact interior"
    from slam2d_tpu.grid.window import blur_halo_cells

    sigma_cells = mcfg.sigma_m / resolution
    k = _gaussian_kernel_1d(sigma_cells, blur_halo_cells(mcfg, resolution))
    if blur_impl != "xla":
        raise ValueError(
            f"unknown blur_impl {blur_impl!r}; valid values: {BLUR_IMPLS}"
        )
    blurred = _separable_blur(occ, k)
    blur = jnp.clip(blurred, 0.0, 1.0)
    free = (p < mcfg.free_threshold).astype(jnp.float32)
    return blur - mcfg.free_penalty * free * (1.0 - blur)


def _separable_blur(img, k: np.ndarray):
    """Separable blur as static shift-and-add (zero padding): 2*K
    statically-shifted adds that XLA fuses with the surrounding field
    math, instead of a [1, 1, H, W] x [1, 1, K, 1] convolution."""
    hw = len(k) // 2

    def blur_axis(x, axis):
        size = x.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (hw, hw)
        xp = jnp.pad(x, pad)
        acc = None
        for i, kv in enumerate(k):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(i, i + size)
            term = float(kv) * xp[tuple(sl)]
            acc = term if acc is None else acc + term
        return acc

    return blur_axis(blur_axis(img, 0), 1)


def coarse_space(S, factor: int):
    """Conservative (max-pool) coarse search space. Non-divisible shapes
    are padded with a large negative value (never becomes the argmax)."""
    H, W = S.shape
    ph = (-H) % factor
    pw = (-W) % factor
    if ph or pw:
        S = jnp.pad(S, ((0, ph), (0, pw)), constant_values=-1e9)
        H, W = S.shape
    return S.reshape(H // factor, factor, W // factor, factor).max(axis=(1, 3))


def _theta_offsets(mcfg: MatcherConfig) -> np.ndarray:
    """Rotation candidates; n_theta == 1 means 'no rotation search' ([0])."""
    if mcfg.n_theta <= 1:
        return np.zeros(1, np.float32)
    return np.linspace(
        -mcfg.search_theta, mcfg.search_theta, mcfg.n_theta
    ).astype(np.float32)


SCORE_IMPLS = ("gather", "mxu", "mxu_int8", "emx")
BLUR_IMPLS = ("xla",)


def _resolve_impl(impl: str) -> str:
    """Concrete scorer for MatcherConfig.score_impl. Both autos ("auto"
    for the frontend's single big match, "auto_refine" for vmapped
    per-particle refinement) resolve to the direct XLA gather on every
    backend; the one-hot-matmul scorers (mxu, mxu_int8, emx) stay as
    explicit choices. Unknown values raise."""
    if impl in ("auto", "auto_refine"):
        return "gather"
    if impl not in SCORE_IMPLS:
        raise ValueError(
            f"unknown score_impl {impl!r}; valid values: "
            f"{('auto', 'auto_refine') + SCORE_IMPLS}"
        )
    return impl


def score_offsets(
    S,
    prior_pose,
    pts_local,
    valid,
    dthetas,
    drows,
    dcols,
    cell_size: float,
    origin_xy,
    bilinear: bool = False,
    impl: str = "gather",
    use_bf16: bool = True,
):
    """Score every (dtheta, drow, dcol) candidate around prior_pose.

    A candidate pose is prior ⊞ (dcol*cell, drow*cell, dtheta) in the WORLD
    frame (translation offsets are world-axis aligned, like the reference's
    grid search). Score = mean over valid beams of S at the beam endpoints;
    with `bilinear` the field is sampled at the fractional endpoint position
    (unbiased, sharper peak — used for the fine pass).

    Args:
      S: [H, W] search space at resolution `cell_size` anchored at origin_xy.
      prior_pose: [3].
      pts_local: [B, 2] beam endpoints in the sensor frame.
      valid: [B] bool.
      dthetas: [T] rotation offsets (radians).
      drows / dcols: [R] / [C] integer cell offsets.
    Returns:
      [T, R, C] float32 scores in [0, 1].
    """
    H, W = S.shape
    theta = prior_pose[2] + dthetas                       # [T]
    pts = se2.rotate_points(theta, pts_local[None, :, :])  # [T, B, 2]
    # fractional position in cell-center coordinates; invalid beams are
    # force-zeroed — a NaN range would otherwise leak through the bilinear
    # fractional weights (0 * NaN = NaN) and poison every candidate score
    pos_col = (pts[..., 0] + prior_pose[0] - origin_xy[0]) / cell_size - 0.5
    pos_row = (pts[..., 1] + prior_pose[1] - origin_xy[1]) / cell_size - 0.5
    pos_col = jnp.where(valid[None, :], pos_col, 0.0)
    pos_row = jnp.where(valid[None, :], pos_row, 0.0)

    denom = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)

    impl = _resolve_impl(impl)
    if impl in ("mxu", "mxu_int8", "emx"):
        # requires drows/dcols to be contiguous symmetric ranges (they are,
        # for both matcher passes) — these paths derive offsets from R, C
        from slam2d_tpu.ops.mxu_score import (
            score_offsets_emx,
            score_offsets_mxu,
            score_offsets_mxu_int8,
        )

        if impl == "mxu_int8":
            return (
                score_offsets_mxu_int8(
                    S, pos_row, pos_col, valid,
                    R=drows.shape[0], C=dcols.shape[0], bilinear=bilinear,
                )
                / denom
            )
        fn = score_offsets_emx if impl == "emx" else score_offsets_mxu
        return (
            fn(
                S, pos_row, pos_col, valid,
                R=drows.shape[0], C=dcols.shape[0], bilinear=bilinear,
                use_bf16=use_bf16,
            )
            / denom
        )

    flat = S.reshape(-1)

    def gather_sum(base_row, base_col, beam_w):
        """Sum_b w_b * S[base_row_b + drow, base_col_b + dcol] -> [T, R, C]."""
        rows = base_row[:, None, :] + drows[None, :, None]    # [T, R, B]
        cols = base_col[:, None, :] + dcols[None, :, None]    # [T, C, B]
        in_r = (rows >= 0) & (rows < H)
        in_c = (cols >= 0) & (cols < W)
        rows = jnp.clip(rows, 0, H - 1)
        cols = jnp.clip(cols, 0, W - 1)
        idx = rows[:, :, None, :] * W + cols[:, None, :, :]   # [T, R, C, B]
        vals = jnp.take(flat, idx.reshape(-1), mode="clip").reshape(idx.shape)
        mask = in_r[:, :, None, :] & in_c[:, None, :, :]
        w = jnp.where(mask, beam_w[:, None, None, :], 0.0)
        return jnp.sum(vals * w, axis=-1)

    vweight = valid.astype(jnp.float32)[None, :]              # [1, B]
    if not bilinear:
        base_col = jnp.round(pos_col).astype(jnp.int32)
        base_row = jnp.round(pos_row).astype(jnp.int32)
        return gather_sum(base_row, base_col, vweight * jnp.ones_like(pos_col)) / denom

    c0 = jnp.floor(pos_col)
    r0 = jnp.floor(pos_row)
    fc = pos_col - c0                                         # [T, B]
    fr = pos_row - r0
    c0 = c0.astype(jnp.int32)
    r0 = r0.astype(jnp.int32)
    acc = gather_sum(r0, c0, vweight * (1 - fr) * (1 - fc))
    acc += gather_sum(r0, c0 + 1, vweight * (1 - fr) * fc)
    acc += gather_sum(r0 + 1, c0, vweight * fr * (1 - fc))
    acc += gather_sum(r0 + 1, c0 + 1, vweight * fr * fc)
    return acc / denom


def _argmax3(scores):
    """(t, r, c) index of the max of a [T, R, C] array."""
    flat_idx = jnp.argmax(scores.reshape(-1))
    T, R, C = scores.shape
    t = flat_idx // (R * C)
    rc = flat_idx % (R * C)
    return t, rc // C, rc % C


def peak_uniqueness(
    logodds,
    ranges,
    prior_pose,
    gcfg: GridConfig,
    mcfg: MatcherConfig,
    sensor: SensorConfig,
    excl_m: float = 0.5,
    search_space=None,
    origin_xy=None,
):
    """Peak-dominance diagnostic for (loop-closure) matches.

    Scores the coarse search window and returns best - second_best, where
    second_best excludes translations within excl_m of the argmax (any
    theta). Corridor/lattice-aliased matches show several near-equal peaks
    and a small margin; genuinely unique alignments a large one.
    """
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution)
        if search_space is None
        else search_space
    )
    f = mcfg.coarse_factor
    Sc = coarse_space(S, f)
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    if origin_xy is None:
        origin = jnp.asarray([gcfg.origin_x, gcfg.origin_y], dtype=jnp.float32)
    else:
        origin = jnp.stack(
            [jnp.asarray(origin_xy[0], jnp.float32),
             jnp.asarray(origin_xy[1], jnp.float32)]
        )
    dthetas = jnp.asarray(_theta_offsets(mcfg), dtype=jnp.float32)
    r_coarse = int(math.ceil(int(round(mcfg.search_xy / gcfg.resolution)) / f))
    off = jnp.arange(-r_coarse, r_coarse + 1, dtype=jnp.int32)
    impl = _resolve_impl(mcfg.score_impl)
    sc = score_offsets(
        Sc, prior_pose, pts_local, valid, dthetas, off, off,
        gcfg.resolution * f, origin, impl=impl, use_bf16=mcfg.score_bf16,
    )
    t, r, c = _argmax3(sc)
    best = sc[t, r, c]
    excl = int(math.ceil(excl_m / (gcfg.resolution * f)))
    far = (
        (jnp.abs(off[None, :, None] - off[r]) > excl)
        | (jnp.abs(off[None, None, :] - off[c]) > excl)
    )
    second = jnp.max(jnp.where(far, sc, -jnp.inf))
    return best - second


def match_scan(
    logodds,
    ranges,
    prior_pose,
    gcfg: GridConfig,
    mcfg: MatcherConfig,
    sensor: SensorConfig,
    search_space=None,
    origin_xy=None,
):
    """Coarse-to-fine correlative match of one scan against the grid.

    Returns (pose [3], score scalar). A Gaussian motion-model penalty
    (prior_*_weight) regularizes the argmax toward the odometry prior —
    this both breaks plateau ties in flat score regions and mirrors the
    reference's odometry-trusting behavior. If the best fine score is below
    mcfg.min_score the prior pose is returned, which covers the empty-map
    first scans.
    """
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution)
        if search_space is None
        else search_space
    )
    f = mcfg.coarse_factor
    Sc = coarse_space(S, f)

    pts_local, valid = scan_endpoints_local(ranges, sensor)
    if origin_xy is None:
        origin = jnp.asarray([gcfg.origin_x, gcfg.origin_y], dtype=jnp.float32)
    else:
        origin = jnp.stack(
            [jnp.asarray(origin_xy[0], jnp.float32),
             jnp.asarray(origin_xy[1], jnp.float32)]
        )

    dthetas = jnp.asarray(_theta_offsets(mcfg), dtype=jnp.float32)

    def penalty(dx_m, dy_m, dth):
        """Motion-prior penalty surface [T, R, C] from per-axis offsets."""
        return (
            mcfg.prior_theta_weight * (dth**2)[:, None, None]
            + mcfg.prior_xy_weight * (dy_m**2)[None, :, None]
            + mcfg.prior_xy_weight * (dx_m**2)[None, None, :]
        )

    # --- coarse pass over the full window ---------------------------------
    # When the whole translation window fits inside one fine pass
    # (r_fine <= coarse_factor — typical for PF refinement's tight search),
    # the pyramid adds nothing: skip the coarse pass and search the exact
    # window at full resolution in a single (bilinear) pass.
    r_fine = int(round(mcfg.search_xy / gcfg.resolution))
    impl = _resolve_impl(mcfg.score_impl)
    single_pass = r_fine <= f
    T_th = dthetas.shape[0]
    if single_pass:
        coarse_dx = jnp.float32(0.0)
        coarse_dy = jnp.float32(0.0)
        prior2 = prior_pose
        fine_off = jnp.arange(-r_fine, r_fine + 1, dtype=jnp.int32)
        dth_fine = dthetas
    else:
        r_coarse = int(math.ceil(r_fine / f))
        coarse_off = jnp.arange(-r_coarse, r_coarse + 1, dtype=jnp.int32)
        cs = gcfg.resolution * f
        sc = score_offsets(
            Sc, prior_pose, pts_local, valid, dthetas, coarse_off, coarse_off,
            cs, origin, impl=impl, use_bf16=mcfg.score_bf16,
        )
        off_m = coarse_off.astype(jnp.float32) * cs
        sc = sc - penalty(off_m, off_m, dthetas)
        tc, rc, cc = _argmax3(sc)
        coarse_dx = coarse_off[cc].astype(jnp.float32) * cs
        coarse_dy = coarse_off[rc].astype(jnp.float32) * cs
        prior2 = jnp.stack(
            [prior_pose[0] + coarse_dx, prior_pose[1] + coarse_dy, prior_pose[2]]
        )

        # --- fine pass: +/- one coarse cell at full res, bilinear ----------
        fine_off = jnp.arange(-f, f + 1, dtype=jnp.int32)
        # Theta restriction (MatcherConfig.fine_theta_bins): the coarse
        # pass searched ALL theta bins at the same theta resolution (the
        # pyramid coarsens only translation), so the fine pass needs only
        # a neighborhood of the coarse theta winner. Value-dynamic,
        # shape-static slice of the theta grid; the scorer's one-hot
        # traffic scales with the theta count.
        ftb = mcfg.fine_theta_bins
        if 0 <= ftb and 2 * ftb + 1 < T_th:
            nft = 2 * ftb + 1
            t0 = jnp.clip(tc - ftb, 0, T_th - nft)
            dth_fine = lax.dynamic_slice(dthetas, (t0,), (nft,))
        else:
            dth_fine = dthetas
    sf = score_offsets(
        S, prior2, pts_local, valid, dth_fine, fine_off, fine_off,
        gcfg.resolution, origin, bilinear=True, impl=impl, use_bf16=mcfg.score_bf16,
    )
    fine_m = fine_off.astype(jnp.float32) * gcfg.resolution
    sf_raw = sf
    sf = sf - penalty(coarse_dx + fine_m, coarse_dy + fine_m, dth_fine)
    tf_, rf, cf = _argmax3(sf)
    # the PENALIZED surface picks the pose; the RAW field value at that
    # pose is the reported/gated match quality (min_score is calibrated
    # for the [~0, 1] field range, and downstream weighting wants the
    # likelihood, not likelihood-minus-prior)
    best = sf_raw[tf_, rf, cf]

    # --- sub-cell / sub-bin quadratic peak interpolation -------------------
    def subpeak(axis_idx, along):
        """1-D quadratic refinement of the peak along one axis of sf."""
        n = sf.shape[along]
        i0 = jnp.clip(axis_idx, 1, n - 2)
        sl = [tf_, rf, cf]
        sm = sl.copy(); sm[along] = i0 - 1
        s0 = sl.copy(); s0[along] = i0
        sp = sl.copy(); sp[along] = i0 + 1
        vm, v0, vp = sf[tuple(sm)], sf[tuple(s0)], sf[tuple(sp)]
        denom = vm - 2.0 * v0 + vp
        d = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (vm - vp) / denom, 0.0)
        d = jnp.clip(d, -0.5, 0.5)
        # Only valid if the argmax wasn't clamped at the window border.
        return jnp.where((axis_idx >= 1) & (axis_idx <= n - 2), d, 0.0)

    dth_step = float(2 * mcfg.search_theta / max(mcfg.n_theta - 1, 1))
    sub_t = subpeak(tf_, 0) * dth_step
    sub_r = subpeak(rf, 1) * gcfg.resolution
    sub_c = subpeak(cf, 2) * gcfg.resolution

    pose = jnp.stack(
        [
            prior2[0] + fine_off[cf].astype(jnp.float32) * gcfg.resolution + sub_c,
            prior2[1] + fine_off[rf].astype(jnp.float32) * gcfg.resolution + sub_r,
            se2.wrap_angle(prior_pose[2] + dth_fine[tf_] + sub_t),
        ]
    )
    pose = jnp.where(best >= mcfg.min_score, pose, prior_pose)
    return pose, best
