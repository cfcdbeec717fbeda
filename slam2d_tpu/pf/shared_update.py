"""Shared-anchor batched PF map update: G scan images, P shifted adds.

The per-particle update path (vmapped _windowed_update) runs the update
kernel once per particle. But the SCAN is common to all particles, exactly as in
pf/shared_refine.py: if each particle's update is anchored on the map
cell lattice (applied at its pose's CELL CENTER) and rotations are
quantized to a global theta grid, the update IMAGE depends only on
(scan, theta slot) — shared — so:

  1. build G update images of the scan, each in a window frame whose
     center cell holds the sensor (G kernel runs on ONE window instead
     of P),
  2. per particle: select its slot's image (a row gather — exact) and
     ADD it into its map window at its anchor cell (pure memory
     bandwidth).

Quantization semantics (intentional, ATE-validated like shared_refine's):
marks land at the pose's cell-center + slot-heading rather than the exact
pose — a sub-cell translation error (< res/2 per axis) plus an angular
error of at most slot_step/2 (endpoint displacement r * slot_step / 2;
the slot step targets <= half a cell at the scan's max range, widening
only if the particle heading spread exceeds the grid's coverage). The
particles' POSES and weights stay exact — only their map marks quantize.

Reference anchor: SURVEY.md §4.3 step 4 (per-particle map update),
restructured like §4.3 step 2's shared refinement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam2d_tpu.config import FrontendConfig, PFConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import (
    cell_center_world,
    integrate_scan,
    world_to_cell,
)
from slam2d_tpu.grid.window import (
    extract_window,
    update_window_cells,
    write_window,
)


def _circular_mean(theta):
    return jnp.arctan2(jnp.mean(jnp.sin(theta)), jnp.mean(jnp.cos(theta)))


def quantize_update_poses(poses, cfg: FrontendConfig, pf: PFConfig,
                          q_xy: bool = True, q_theta: bool = True):
    """Poses quantized EXACTLY as shared_update anchors its marks: xy to
    the anchor cell center (or the update_subcell sub-cell center), theta
    to the global slot grid. Running the exact per-particle update at
    these poses (update_mode="quantized_per_particle") reproduces the
    shared path's quantization SEMANTICS without its shared-image
    mechanics — the diagnostic A/B for the +0.10-ATE gap (VERDICT r2
    item 3): if ATE matches shared mode, the quantization itself is the
    cause; if it matches per_particle, the gap lives in the shared apply
    path (image sharing / bf16 images / border handling)."""
    gcfg = cfg.grid
    res = gcfg.resolution
    G = pf.update_theta_slots
    theta = poses[:, 2]
    mean_t = _circular_mean(theta)
    dth = se2.wrap_angle(theta - mean_t)
    qstep = (
        2.0 * pf.update_qstep_cells * res / max(cfg.sensor.max_range, res)
    )
    step = jnp.maximum(
        jnp.float32(qstep),
        2.0 * jnp.max(jnp.abs(dth)) / jnp.float32(max(G - 1, 1)),
    )
    slot = jnp.clip(
        jnp.round(dth / step).astype(jnp.int32) + G // 2, 0, G - 1
    )
    th_q = mean_t + (slot.astype(jnp.float32) - G // 2) * step
    anchors = jax.vmap(lambda pr: world_to_cell(pr[:2], gcfg))(poses)
    centers = jax.vmap(lambda a: cell_center_world(a, gcfg))(anchors)
    Q = int(getattr(pf, "update_subcell", 1))
    if Q > 1:
        frac = (poses[:, :2] - centers) / res
        qx = jnp.clip(
            jnp.floor((frac[:, 0] + 0.5) * Q).astype(jnp.int32), 0, Q - 1
        )
        qy = jnp.clip(
            jnp.floor((frac[:, 1] + 0.5) * Q).astype(jnp.int32), 0, Q - 1
        )
        offs = (jnp.arange(Q, dtype=jnp.float32) + 0.5) / Q - 0.5
        xy_q = centers + jnp.stack([offs[qx], offs[qy]], axis=1) * res
    else:
        xy_q = centers
    # axis-separated diagnostics (q_xy/q_theta): round-3 falsified the
    # translation axis (bilinear placement left the 4-seed mean ATE
    # unchanged), so the axes are probed independently via the
    # "quantized_theta_only"/"quantized_xy_only" update modes
    if not q_xy:
        xy_q = poses[:, :2]
    if not q_theta:
        th_q = poses[:, 2]
    return jnp.concatenate([xy_q, th_q[:, None]], axis=1)


def shared_update(logodds, poses, ranges, cfg: FrontendConfig,
                  pf: PFConfig, dither_key=None):
    """Update every particle's map with one scan (module docstring).

    logodds: [P, H, W]; poses: [P, 3]. Returns updated [P, H, W]."""
    import dataclasses

    gcfg = cfg.grid
    res = gcfg.resolution
    P = poses.shape[0]
    win = update_window_cells(gcfg, cfg.sensor)
    win = min(win, min(gcfg.height, gcfg.width))
    G = pf.update_theta_slots

    # ---- global theta grid ----------------------------------------------
    theta = poses[:, 2]
    mean_t = _circular_mean(theta)
    dth = se2.wrap_angle(theta - mean_t)
    # slot step: update_qstep_cells-cell endpoint error at max range
    # (default half-cell) unless the cloud's spread needs wider coverage
    # (then error degrades gracefully)
    qstep = (
        2.0 * pf.update_qstep_cells * res / max(cfg.sensor.max_range, res)
    )
    step = jnp.maximum(
        jnp.float32(qstep),
        2.0 * jnp.max(jnp.abs(dth)) / jnp.float32(max(G - 1, 1)),
    )
    # theta-grid phase jitter (config.update_anchor_dither docstring):
    # shift the WHOLE slot grid by a per-event uniform phase so that a
    # particle sitting near a slot boundary doesn't flip slots
    # chaotically from event to event — the direct A/B for the
    # slot-boundary-chaos residual hypothesis. Exactness is unchanged
    # (slot_theta shifts with the grid; per-particle error stays
    # <= step/2).
    dmode = getattr(pf, "update_anchor_dither", "off")
    if dmode not in ("off", "random", "theta_phase", "both"):
        # fail loudly: a misspelled mode would otherwise silently run
        # the undithered control (and poison multi-hour A/Bs)
        raise ValueError(f"unknown update_anchor_dither {dmode!r}")
    if dither_key is not None and dmode in ("theta_phase", "both"):
        k_th = jax.random.fold_in(dither_key, 1)
        phase = jax.random.uniform(k_th, minval=-0.5, maxval=0.5) * step
    else:
        phase = jnp.float32(0.0)
    slot = jnp.clip(
        jnp.round((dth - phase) / step).astype(jnp.int32) + G // 2,
        0, G - 1,
    )
    slot_theta = (
        mean_t + phase
        + (jnp.arange(G, dtype=jnp.float32) - G // 2) * step
    )

    # ---- G update images in a window frame -------------------------------
    # frame: world (0, 0) at the CENTER of cell (win//2, win//2)
    img_origin = (
        jnp.float32(-(win // 2) * res - 0.5 * res),
        jnp.float32(-(win // 2) * res - 0.5 * res),
    )
    # images must be raw increments: clamp can't bind on a zero window
    # for one scan (|upd| <= a few increments << l_clamp)
    img_cfg = dataclasses.replace(gcfg, height=win, width=win)
    # Exact-endpoint mode (update_exact_endpoints): the shared images
    # carry the FREE-SPACE carve only (l_occ=0 — the dense carve
    # tolerates the anchor snap) and the occupancy peaks are added
    # afterwards at each particle's EXACT endpoint cells (~B points,
    # grid/occupancy.endpoint_update). Round-4 axis probes pinned the
    # shared update's +0.09 seed-averaged ATE gap on the TRANSLATION
    # quantization (quantized_xy_only 0.250 vs quantized_theta_only
    # 0.183, per_particle 0.166, 4 seeds); the endpoint marks are
    # what the correlative matcher locks onto, so they must not snap.
    exact_ep = bool(getattr(pf, "update_exact_endpoints", False))
    img_ranges = ranges
    if exact_ep:
        img_cfg = dataclasses.replace(img_cfg, l_occ=0.0)
        # pull the carve update_carve_shrink cells short of the measured
        # endpoint: the anchor snap displaces the shared carve by up to
        # ~a cell, so without the margin it can cross (and erode) the
        # exact endpoint marks added below
        shrink = float(getattr(pf, "update_carve_shrink", 0.0))
        if shrink > 0.0:
            img_ranges = jnp.maximum(ranges - shrink * res, 0.0)

    def one_image(th, off_xy):
        pose_g = jnp.concatenate([off_xy, th[None]])
        return integrate_scan(
            jnp.zeros((win, win), jnp.float32), pose_g, img_ranges,
            img_cfg, cfg.sensor, origin_xy=img_origin,
        )

    # ---- optional sub-cell anchors (update_subcell=2) ---------------------
    # each theta slot splits into a QxQ grid of sensor-position offsets
    # inside the anchor cell (Q=2: offsets ±res/4 -> max translation
    # quantization error drops from res/2 to res/4 per axis at Q^2 x the
    # image-build cost). The particle picks the sub-cell of its pose's
    # fraction within the anchor cell.
    Q = int(getattr(pf, "update_subcell", 1))
    # random anchor dither (config.update_anchor_dither docstring): the
    # CARVE's anchor choice gets an independent per-particle half-cell
    # offset so its translation snap decorrelates across particles/time;
    # snapped mode only (subcell/bilinear place sub-cell themselves, and
    # their frac math assumes the undithered anchor)
    anchor_src = poses
    if (dither_key is not None
            and dmode in ("random", "both")
            and Q == 1 and not bool(getattr(pf, "update_bilinear", False))):
        u = jax.random.uniform(
            dither_key, (P, 2), minval=-0.5, maxval=0.5
        ) * res
        anchor_src = jnp.concatenate(
            [poses[:, :2] + u, poses[:, 2:]], axis=1
        )
    anchors = jax.vmap(lambda pr: world_to_cell(pr[:2], gcfg))(anchor_src)
    if Q > 1:
        centers = jax.vmap(lambda a: cell_center_world(a, gcfg))(anchors)
        frac = (poses[:, :2] - centers) / res            # [-0.5, 0.5) per axis
        qx = jnp.clip(
            jnp.floor((frac[:, 0] + 0.5) * Q).astype(jnp.int32), 0, Q - 1
        )
        qy = jnp.clip(
            jnp.floor((frac[:, 1] + 0.5) * Q).astype(jnp.int32), 0, Q - 1
        )
        slot = (slot * Q + qy) * Q + qx                  # [P] in [0, G*Q*Q)
        offs = (jnp.arange(Q, dtype=jnp.float32) + 0.5) / Q - 0.5  # cell frac
        th_g, oy_g, ox_g = jnp.meshgrid(
            slot_theta, offs * res, offs * res, indexing="ij"
        )
        images = jax.vmap(one_image)(
            th_g.reshape(-1),
            jnp.stack([ox_g.reshape(-1), oy_g.reshape(-1)], axis=1),
        )                                                # [G*Q*Q, win, win]
        G = G * Q * Q
    else:
        images = jax.vmap(
            lambda th: one_image(th, jnp.zeros((2,), jnp.float32))
        )(slot_theta)                                    # [G, win, win]

    # images follow the map dtype (the increments are a few tenths; a bf16
    # map rounds them on the add either way)
    images = images.astype(logodds.dtype)

    # ---- per-particle select + shifted add -------------------------------
    # Bilinear sub-cell placement (update_bilinear): land each particle's
    # image at anchor + frac (a 2x2-tap blend) instead of snapping to the
    # anchor cell — removes the shared update's TRANSLATION quantization
    # to first order at no extra memory traffic (the quantized_per_particle
    # A/B pinned the ATE gap on the quantization semantics). Redundant
    # with update_subcell>1.
    bilinear = bool(getattr(pf, "update_bilinear", False)) and Q == 1
    imgs_p = jnp.take(images, slot, axis=0)           # [P, win, win]
    if bilinear:
        centers_b = jax.vmap(lambda a: cell_center_world(a, gcfg))(anchors)
        frac_rc = jnp.stack(
            [
                (poses[:, 1] - centers_b[:, 1]) / res,   # row tracks +y
                (poses[:, 0] - centers_b[:, 0]) / res,   # col tracks +x
            ],
            axis=1,
        )
        imgs_p = bilinear_place(imgs_p.astype(jnp.float32), frac_rc)
    out = apply_images(logodds, anchors, imgs_p, win, gcfg.l_clamp,
                       pf.refine_chunk)
    if exact_ep:
        out = _exact_endpoint_pass(out, poses, anchors, ranges, cfg, pf)
    return out


def bilinear_place(imgs, frac_rc):
    """Shift each [win, win] image by its fractional (row, col) offset
    with a 2x2-tap blend — the mass centroid moves by exactly frac_rc.
    The update window has >= 8 cells of slack past max_range, so the
    +-1-cell shift never clips real content at interior anchors."""

    def blend(img, fr):
        b = jnp.floor(fr).astype(jnp.int32)
        s = fr - b.astype(jnp.float32)
        img = jnp.roll(img, (b[0], b[1]), axis=(0, 1))
        img = img * (1.0 - s[0]) + jnp.roll(img, 1, axis=0) * s[0]
        img = img * (1.0 - s[1]) + jnp.roll(img, 1, axis=1) * s[1]
        return img

    return jax.vmap(blend)(imgs, frac_rc)


def apply_images(logodds, anchors, imgs_p, win: int, l_clamp: float,
                 chunk: int = 0):
    """Add imgs_p[p] into logodds[p]'s win x win window centered on cell
    anchors[p], clamped to +-l_clamp. At map borders the window clamps
    inside the map and the image cells that fall outside it drop.
    `chunk` > 0 processes particles in lax.map chunks of that size."""

    def apply(g, anchor, img):
        gw, (r0, c0) = extract_window(g, anchor, win)
        # at map borders extract_window clamps; roll the IMAGE to the
        # clamped frame and drop the out-of-map band
        dr = (anchor[0] - win // 2) - r0
        dc = (anchor[1] - win // 2) - c0
        img2 = jnp.roll(img, (dr, dc), axis=(0, 1))
        i = jnp.arange(win, dtype=jnp.int32)
        rmask = (i - dr >= 0) & (i - dr < win)
        cmask = (i - dc >= 0) & (i - dc < win)
        img2 = img2 * (rmask[:, None] & cmask[None, :]).astype(img2.dtype)
        gw2 = jnp.clip(
            gw.astype(jnp.float32) + img2.astype(jnp.float32),
            -l_clamp, l_clamp,
        ).astype(g.dtype)
        return write_window(g, gw2, (r0, c0))

    P = logodds.shape[0]
    if chunk and P > chunk:
        nc = P // chunk
        Hg, Wg = logodds.shape[-2:]
        out = jax.lax.map(
            lambda args: jax.vmap(apply)(args[0], args[1], args[2]),
            (
                logodds.reshape(nc, chunk, Hg, Wg),
                anchors.reshape(nc, chunk, 2),
                imgs_p.reshape(nc, chunk, win, win),
            ),
        )
        return out.reshape(P, Hg, Wg)
    return jax.vmap(apply)(logodds, anchors, imgs_p)


def _exact_endpoint_pass(logodds, poses, anchors, ranges,
                         cfg: FrontendConfig, pf: PFConfig):
    """Add each particle's occupancy marks at its EXACT endpoint cells
    (grid/occupancy.endpoint_update) inside the same anchor-centered
    update window the shared apply wrote. ~B points/particle of
    scatter-add — cheap next to the dense carve."""
    from slam2d_tpu.grid.occupancy import endpoint_update

    gcfg = cfg.grid
    P = poses.shape[0]
    win = update_window_cells(gcfg, cfg.sensor)
    win = min(win, min(gcfg.height, gcfg.width))

    def one(g, pose, anchor):
        gw, orc = extract_window(g, anchor, win)
        gw2 = endpoint_update(
            gw, pose, ranges, gcfg, cfg.sensor,
            origin_rc=jnp.stack(orc),
        )
        return write_window(g, gw2, orc)

    if pf.refine_chunk and P > pf.refine_chunk:
        nc = P // pf.refine_chunk
        Hg, Wg = logodds.shape[-2:]
        out = jax.lax.map(
            lambda args: jax.vmap(one)(args[0], args[1], args[2]),
            (
                logodds.reshape(nc, pf.refine_chunk, Hg, Wg),
                poses.reshape(nc, pf.refine_chunk, 3),
                anchors.reshape(nc, pf.refine_chunk, 2),
            ),
        )
        return out.reshape(P, Hg, Wg)
    return jax.vmap(one)(logodds, poses, anchors)
