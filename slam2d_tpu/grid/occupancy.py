"""Log-odds occupancy grid as a fixed-shape JAX array (SURVEY.md §4.2, L1).

The reference keeps a dynamically-growing per-object NumPy grid updated one
beam at a time; here the grid is a static `[H, W]` float32 log-odds tensor
(rows = y, cols = x, world-anchored at GridConfig.origin) and the whole scan
updates in one fused scatter-add:

- every beam is sampled at `ray_samples` static points along the ray
  (free-space update, per-sample increment rescaled so the *per-cell* free
  evidence is independent of the oversampling factor),
- endpoint cells (hits with r < max_range) get the occupied update,
- everything clamps to +/- l_clamp.

Static shapes mean the same code vmaps over particles ([P, H, W] maps,
SURVEY.md §4.3) and shards over mesh axes unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import GridConfig, SensorConfig


def make_grid(cfg: GridConfig, dtype=jnp.float32):
    """Fresh all-unknown (log-odds 0) grid."""
    return jnp.zeros((cfg.height, cfg.width), dtype=dtype)


def occupancy_prob(logodds):
    """p(occupied) = 1 - 1/(1+e^l) = sigmoid(l)."""
    return jax.nn.sigmoid(logodds)


def world_to_cell_float(xy, cfg: GridConfig):
    """World (x, y) -> fractional (row, col). Row = y axis, col = x axis."""
    col = (xy[..., 0] - cfg.origin_x) / cfg.resolution
    row = (xy[..., 1] - cfg.origin_y) / cfg.resolution
    return jnp.stack([row, col], axis=-1)


def world_to_cell(xy, cfg: GridConfig):
    """World (x, y) -> integer (row, col) cell index (not clipped)."""
    rc = world_to_cell_float(xy, cfg)
    return jnp.floor(rc).astype(jnp.int32)


def cell_center_world(rc, cfg: GridConfig):
    """Integer (row, col) -> world (x, y) of the cell center."""
    row = rc[..., 0].astype(jnp.float32)
    col = rc[..., 1].astype(jnp.float32)
    x = cfg.origin_x + (col + 0.5) * cfg.resolution
    y = cfg.origin_y + (row + 0.5) * cfg.resolution
    return jnp.stack([x, y], axis=-1)


def beam_angles(sensor: SensorConfig):
    return jnp.asarray(np.asarray(sensor.beam_angles()), dtype=jnp.float32)


def raycast_update(
    logodds,
    pose,
    ranges,
    cfg: GridConfig,
    sensor: SensorConfig,
    enable=1.0,
    origin_xy=None,
    origin_rc=None,
    accumulate: str = "scatter",
):
    """Integrate one scan taken from `pose` into the log-odds grid.

    Args:
      logodds: [H, W] float32 — the full grid OR an extracted window.
      pose: [3] (x, y, theta) world pose of the sensor.
      ranges: [B] float32 measured ranges (pre-clipped or raw).
      enable: scalar in {0, 1} multiplying all increments — lets a jitted
        caller gate the update (motion filter) without dynamic control flow.
      origin_xy: world (x, y) of cell (0, 0); defaults to the grid config's
        origin — pass the window origin when updating a window.
      origin_rc: integer (row, col) of the window's top-left cell ON THE
        CONFIG GRID's lattice. When given it takes precedence over
        origin_xy and cell indices are computed as full-grid floor minus
        the integer offset — bit-exact with the full-grid path (a float
        window origin rounds boundary-straddling samples differently).
      accumulate: "scatter" (XLA scatter-add) or "mxu" (one-hot matmul
        accumulation, ops/mxu_update.py). Same samples, same result up to
        float summation order and the matmul's bf16 weights.
    Returns:
      updated [H, W] log-odds.
    """
    H, W = logodds.shape
    if origin_rc is not None:
        ox, oy = cfg.origin_x, cfg.origin_y
        roff = origin_rc[0].astype(jnp.int32)
        coff = origin_rc[1].astype(jnp.int32)
    else:
        roff = coff = jnp.int32(0)
        if origin_xy is None:
            ox, oy = cfg.origin_x, cfg.origin_y
        else:
            ox, oy = origin_xy
    angles = beam_angles(sensor) + pose[2]          # [B] world bearing
    r = ranges.astype(jnp.float32)
    valid = (r > sensor.min_range) & jnp.isfinite(r)
    hit = valid & (r < sensor.max_range)
    r_clip = jnp.clip(r, 0.0, sensor.max_range)

    dirx = jnp.cos(angles)
    diry = jnp.sin(angles)

    # --- free-space samples -------------------------------------------------
    S = cfg.ray_samples
    # Stop one cell short of the endpoint so the hit cell keeps its evidence.
    r_free = jnp.maximum(r_clip - cfg.resolution, 0.0)          # [B]
    frac = (jnp.arange(S, dtype=jnp.float32) + 0.5) / S          # [S]
    d = r_free[:, None] * frac[None, :]                          # [B, S]
    fx = pose[0] + dirx[:, None] * d
    fy = pose[1] + diry[:, None] * d
    fcol = jnp.floor((fx - ox) / cfg.resolution).astype(jnp.int32) - coff
    frow = jnp.floor((fy - oy) / cfg.resolution).astype(jnp.int32) - roff

    # Per-sample increment scaled so that a traversed cell accumulates about
    # l_free total regardless of how many of the S samples land inside it.
    spacing = r_free / S                                         # [B]
    scale = jnp.minimum(spacing / cfg.resolution, 1.0)           # [B]
    free_w = cfg.l_free * scale[:, None] * valid[:, None]        # [B, S]

    in_bounds = (frow >= 0) & (frow < H) & (fcol >= 0) & (fcol < W)
    free_w = jnp.where(in_bounds, free_w, 0.0)
    frow = jnp.clip(frow, 0, H - 1)
    fcol = jnp.clip(fcol, 0, W - 1)

    # --- endpoint (occupied) samples ---------------------------------------
    ex = pose[0] + dirx * r_clip
    ey = pose[1] + diry * r_clip
    ecol = jnp.floor((ex - ox) / cfg.resolution).astype(jnp.int32) - coff
    erow = jnp.floor((ey - oy) / cfg.resolution).astype(jnp.int32) - roff
    e_in = (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    occ_w = jnp.where(hit & e_in, cfg.l_occ, 0.0)                # [B]
    erow = jnp.clip(erow, 0, H - 1)
    ecol = jnp.clip(ecol, 0, W - 1)

    rows = jnp.concatenate([frow.reshape(-1), erow])
    cols = jnp.concatenate([fcol.reshape(-1), ecol])
    w = jnp.concatenate([free_w.reshape(-1), occ_w])
    w = w * enable

    if accumulate == "mxu":
        # scatter-add as one [H, S] @ [S, W] one-hot contraction
        from slam2d_tpu.ops.mxu_update import scatter_add_mxu

        img = scatter_add_mxu(rows, cols, w, H, W)
        out = logodds + img.astype(logodds.dtype)
    else:
        out = logodds.at[rows, cols].add(
            w.astype(logodds.dtype), mode="drop"
        )
    return jnp.clip(out, -cfg.l_clamp, cfg.l_clamp)


def raycast_update_dense(
    logodds,
    pose,
    ranges,
    cfg: GridConfig,
    sensor: SensorConfig,
    enable=1.0,
    origin_xy=None,
):
    """Inverse-sensor-model scan integration with ZERO scatter ops.

    The sparse formulation (raycast_update) scatter-adds ~50k ray samples.
    This dense formulation instead evaluates the classic inverse sensor model
    (Probabilistic Robotics ch. 9) at EVERY cell of the (windowed) grid:

      bearing, distance of the cell from the pose -> nearest beam k ->
      free if distance < r_k - resolution, occupied if |distance - r_k|
      is within half a cell (and the beam actually hit).

    Everything is elementwise math plus one tiny gather from the [B]
    range table — fully vectorized, vmappable over particles, and exact for
    the wedge between beams (which ray sampling leaves unobserved).

    Same signature/semantics as raycast_update; pass a window + its origin
    for the hot path.
    """
    H, W = logodds.shape
    if origin_xy is None:
        ox, oy = cfg.origin_x, cfg.origin_y
    else:
        ox, oy = origin_xy

    B = sensor.n_beams
    r = jnp.clip(ranges.astype(jnp.float32), 0.0, sensor.max_range)
    beam_valid = (ranges > sensor.min_range) & jnp.isfinite(ranges)
    beam_hit = beam_valid & (ranges < sensor.max_range)

    # cell-center world coordinates relative to the sensor
    col = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    row = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    cx = ox + (col + 0.5) * cfg.resolution - pose[0]
    cy = oy + (row + 0.5) * cfg.resolution - pose[1]
    d = jnp.hypot(cx, cy)                                   # [H, W]
    phi = jnp.arctan2(cy, cx) - pose[2]                     # bearing
    # relative to angle_min, wrapped into [0, 2*pi): supports wide-FOV
    # (270/360-degree) sensors — a (-pi, pi] wrap would alias the rear
    # sector of a full-circle scan out of FOV
    phi = jnp.mod(phi - sensor.angle_min, 2 * jnp.pi)
    if B > 1:
        step = sensor.fov_rad / (B - 1)
        k = jnp.round(phi / step).astype(jnp.int32)
        in_fov = (k >= 0) & (k < B)
        k = jnp.clip(k, 0, B - 1)
    else:
        # single beam: "FOV" is the ray itself, within half a cell laterally
        # (use the signed wrap here — the beam sits at relative bearing 0)
        phi_signed = jnp.where(phi > jnp.pi, phi - 2 * jnp.pi, phi)
        step = 1.0
        k = jnp.zeros((H, W), jnp.int32)
        in_fov = (jnp.abs(phi_signed) < jnp.pi / 2) & (
            jnp.abs(phi_signed) * d <= 0.75 * cfg.resolution
        )
        phi = phi_signed

    # Consider the nearest beam AND its neighbor on the cell's side: at
    # grazing incidence an endpoint cell's center bearing can round to the
    # adjacent beam whose range differs sharply, which would miss the wall.
    resid = phi - k.astype(jnp.float32) * step
    k2 = jnp.clip(k + jnp.where(resid >= 0, 1, -1), 0, B - 1)

    def per_beam(kk):
        r_b = jnp.take(r, kk.reshape(-1)).reshape(H, W)
        v_b = jnp.take(beam_valid, kk.reshape(-1)).reshape(H, W)
        h_b = jnp.take(beam_hit, kk.reshape(-1)).reshape(H, W)
        cross = jnp.abs(phi - kk.astype(jnp.float32) * step) * d
        # 0.75 cells: the cell CENTER can sit up to res/sqrt(2) from the
        # endpoint inside it, so 0.5 would miss endpoint cells.
        occ_b = (
            h_b
            & (jnp.abs(d - r_b) <= 0.75 * cfg.resolution)
            & (cross <= 0.75 * cfg.resolution)
        )
        return r_b, v_b, occ_b

    r_k, v_k, occ_k = per_beam(k)
    r_k2, v_k2, occ_k2 = per_beam(k2)

    # free: strictly closer than BOTH adjacent beams' returns (conservative
    # at grazing incidence — never carves through a wall between beams)
    r_min = jnp.where(v_k2, jnp.minimum(r_k, r_k2), r_k)
    free = in_fov & v_k & (d < r_min - cfg.resolution)
    occ = in_fov & (occ_k | occ_k2)

    upd = cfg.l_free * free.astype(jnp.float32) + cfg.l_occ * occ.astype(
        jnp.float32
    )
    out = logodds.astype(jnp.float32) + upd * enable
    return jnp.clip(out, -cfg.l_clamp, cfg.l_clamp).astype(logodds.dtype)


UPDATE_IMPLS = ("sparse", "sparse_mxu", "dense")


def resolve_update_impl(cfg: GridConfig) -> str:
    """Resolve GridConfig.update_impl to the concrete kernel that runs
    (exposed so benches/drivers can REPORT it). "auto" = sampled rays with
    XLA scatter-add accumulation ("sparse") on every backend and at every
    call site. Explicit choices: "sparse_mxu" (the same rays, one-hot-matmul
    accumulation) and "dense" (inverse sensor model at every cell).
    Unknown values raise."""
    impl = cfg.update_impl
    if impl == "auto":
        return "sparse"
    if impl not in UPDATE_IMPLS:
        raise ValueError(
            f"unknown update_impl {impl!r}; valid values: "
            f"{('auto',) + UPDATE_IMPLS}"
        )
    return impl


def integrate_scan(
    logodds, pose, ranges, cfg: GridConfig, sensor: SensorConfig,
    enable=1.0, origin_xy=None, origin_rc=None,
):
    """Scan integration dispatcher: GridConfig.update_impl picks the kernel
    (see resolve_update_impl: "auto" | "sparse" | "sparse_mxu" | "dense").

    origin_rc: integer window offset on the config grid's lattice (see
    raycast_update) — the sparse paths use it for bit-exact windowed
    updates; the dense inverse-sensor-model update evaluates continuous
    cell centers, so it derives the equivalent float origin."""
    impl = resolve_update_impl(cfg)
    if impl == "dense":
        if origin_rc is not None:
            origin_xy = (
                cfg.origin_x
                + origin_rc[1].astype(jnp.float32) * cfg.resolution,
                cfg.origin_y
                + origin_rc[0].astype(jnp.float32) * cfg.resolution,
            )
        return raycast_update_dense(
            logodds, pose, ranges, cfg, sensor, enable=enable,
            origin_xy=origin_xy,
        )
    acc = "mxu" if impl == "sparse_mxu" else "scatter"
    return raycast_update(
        logodds, pose, ranges, cfg, sensor, enable=enable,
        origin_xy=origin_xy, origin_rc=origin_rc, accumulate=acc,
    )


def endpoint_update(
    logodds, pose, ranges, cfg: GridConfig, sensor: SensorConfig,
    enable=1.0, origin_rc=None, accumulate: str = "scatter",
):
    """Occupied-ENDPOINT marks only — the sparse raycast_update's endpoint
    section with the free-space samples stripped (~B points instead of
    ~B*S). The shared PF update pairs this with l_occ=0 shared images:
    the dense free-space carve tolerates the anchor-lattice translation
    snap, but the occupancy peaks the matcher locks onto must land at
    the particle's EXACT endpoint cells (round-4 axis probes pinned the
    shared update's +0.09 ATE gap on the xy axis: quantized_xy_only
    4-seed mean 0.250 vs quantized_theta_only 0.183, per_particle
    0.166)."""
    H, W = logodds.shape
    if origin_rc is not None:
        roff = origin_rc[0].astype(jnp.int32)
        coff = origin_rc[1].astype(jnp.int32)
    else:
        roff = coff = jnp.int32(0)
    ox, oy = cfg.origin_x, cfg.origin_y
    angles = beam_angles(sensor) + pose[2]
    r = ranges.astype(jnp.float32)
    valid = (r > sensor.min_range) & jnp.isfinite(r)
    hit = valid & (r < sensor.max_range)
    r_clip = jnp.clip(r, 0.0, sensor.max_range)
    ex = pose[0] + jnp.cos(angles) * r_clip
    ey = pose[1] + jnp.sin(angles) * r_clip
    ecol = jnp.floor((ex - ox) / cfg.resolution).astype(jnp.int32) - coff
    erow = jnp.floor((ey - oy) / cfg.resolution).astype(jnp.int32) - roff
    e_in = (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    w = jnp.where(hit & e_in, cfg.l_occ, 0.0) * enable
    erow = jnp.clip(erow, 0, H - 1)
    ecol = jnp.clip(ecol, 0, W - 1)
    if accumulate == "mxu":
        from slam2d_tpu.ops.mxu_update import scatter_add_mxu

        img = scatter_add_mxu(erow, ecol, w, H, W)
        out = logodds + img.astype(logodds.dtype)
    else:
        out = logodds.at[erow, ecol].add(w.astype(logodds.dtype), mode="drop")
    return jnp.clip(out, -cfg.l_clamp, cfg.l_clamp)


def scan_endpoints_local(ranges, sensor: SensorConfig):
    """Beam endpoints in the sensor frame, [B, 2], plus a validity mask [B].

    Only hits (min_range < r < max_range) are valid for matching/weighting.
    """
    angles = beam_angles(sensor)
    r = ranges.astype(jnp.float32)
    valid = (r > sensor.min_range) & (r < sensor.max_range) & jnp.isfinite(r)
    r_clip = jnp.clip(r, 0.0, sensor.max_range)
    pts = jnp.stack([r_clip * jnp.cos(angles), r_clip * jnp.sin(angles)], axis=-1)
    return pts, valid
