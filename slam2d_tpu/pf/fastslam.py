"""FastSLAM particle filter over stacked particle arrays (SURVEY.md §4.3, L3).

The reference keeps a Python list of Particle objects, each owning its own
map and matcher, looping over them per scan. Here particle state is a struct
of stacked arrays — poses [P, 3], log-weights [P], maps [P, H, W] — and the
whole per-particle pipeline (propose → refine-match → weight → map update)
is one `vmap` over the particle axis, so XLA batches every kernel across
particles. Log-space weights avoid the underflow the reference risks with
multiplicative weighting.

Resampling is low-variance (systematic): a single uniform draw, ancestors
selected against the weight CDF (SURVEY.md §4.3 step 5), realized as a
gather on the stacked state — including the [P, H, W] map tensor — gated by
the N_eff trigger.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam2d_tpu.config import FrontendConfig, PFConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import integrate_scan, world_to_cell
from slam2d_tpu.grid.window import (
    extract_window,
    scan_window_cells,
    update_window_cells,
    write_window,
)
from slam2d_tpu.match.correlative import build_search_space, match_scan


REFINE_MODES = ("shared", "per_particle")
UPDATE_MODES = ("shared", "per_particle", "quantized_per_particle",
                "quantized_theta_only", "quantized_xy_only")


def _resolve_refine_mode(pf: PFConfig, mcfg) -> str:
    """Resolve PFConfig.refine_mode. "auto" resolves to "per_particle"
    (the vmapped gather-scored matcher) on every backend; the
    shared-anchor stack is an explicit choice. An EXPLICIT "shared"
    request with a theta-less matcher is an error rather than a silent
    fallback."""
    mode = pf.refine_mode
    if mode == "auto":
        return "per_particle"
    if mode not in REFINE_MODES:
        raise ValueError(
            f"unknown refine_mode {mode!r}; valid values: "
            f"{('auto',) + REFINE_MODES}"
        )
    if mode == "shared" and mcfg.n_theta <= 1:
        raise ValueError(
            "refine_mode='shared' needs n_theta > 1 (the shared stack is "
            "built on the global theta grid); got n_theta="
            f"{mcfg.n_theta}. Use refine_mode='per_particle' or 'auto'."
        )
    return mode


def _resolve_update_mode(pf: PFConfig) -> str:
    """Resolve PFConfig.update_mode: "auto" is "per_particle" on every
    backend; "shared" and the quantized diagnostics are explicit."""
    mode = pf.update_mode
    if mode == "auto":
        return "per_particle"
    if mode not in UPDATE_MODES:
        raise ValueError(
            f"unknown update_mode {mode!r}; valid values: "
            f"{('auto',) + UPDATE_MODES}"
        )
    return mode


def refine_matcher(cfg: FrontendConfig, pf: PFConfig):
    """PF refinement matcher config: frontend matcher with the PFConfig
    refine_* overrides applied (None = inherit)."""
    import dataclasses

    m = cfg.matcher
    # an un-pinned ("auto") matcher resolves per context ("auto_refine")
    if pf.refine_score_impl is not None:
        impl = pf.refine_score_impl
    elif m.score_impl == "auto":
        impl = "auto_refine"
    else:
        impl = m.score_impl
    pw = pf.refine_prior_weight
    return dataclasses.replace(
        m,
        search_xy=m.search_xy if pf.refine_xy is None else pf.refine_xy,
        search_theta=(
            m.search_theta if pf.refine_theta is None else pf.refine_theta
        ),
        n_theta=m.n_theta if pf.refine_n_theta is None else pf.refine_n_theta,
        score_impl=impl,
        **({} if pw is None else {
            "prior_xy_weight": pw, "prior_theta_weight": pw,
        }),
    )


def _windowed_match(grid, ranges, prior, cfg: FrontendConfig, mcfg=None):
    """Per-particle match: blur and score only a static window around the
    prior (a scan can't read outside it), not the particle's whole map."""
    mcfg = mcfg or cfg.matcher
    win = scan_window_cells(cfg.grid, cfg.sensor, mcfg)
    if win >= min(cfg.grid.height, cfg.grid.width):
        return match_scan(grid, ranges, prior, cfg.grid, mcfg, cfg.sensor)
    center = world_to_cell(prior[:2], cfg.grid)
    gw, (r0, c0) = extract_window(grid, center, win)
    Sw = build_search_space(gw, mcfg, cfg.grid.resolution)
    origin = (
        cfg.grid.origin_x + c0.astype(jnp.float32) * cfg.grid.resolution,
        cfg.grid.origin_y + r0.astype(jnp.float32) * cfg.grid.resolution,
    )
    return match_scan(
        grid, ranges, prior, cfg.grid, mcfg, cfg.sensor,
        search_space=Sw, origin_xy=origin,
    )


def _windowed_update(grid, pose, ranges, cfg: FrontendConfig, enable=1.0):
    """Per-particle map update restricted to the scan's static window
    (the update's cost scales with the target array size). Uses the
    update-only window (max_range, no search/blur margin) — the PF rebuilds
    its blurred field per refinement, so no cached blur needs widening."""
    win = update_window_cells(cfg.grid, cfg.sensor)
    if win >= min(cfg.grid.height, cfg.grid.width):
        return integrate_scan(
            grid, pose, ranges, cfg.grid, cfg.sensor, enable=enable,
        )
    center = world_to_cell(pose[:2], cfg.grid)
    gw, orc = extract_window(grid, center, win)
    gw = integrate_scan(
        gw, pose, ranges, cfg.grid, cfg.sensor, enable=enable, origin_rc=orc,
    )
    return write_window(grid, gw, orc)


def _resample_copy(stacked, ancestors):
    """Copy ancestor rows of a [P, ...] tensor: one row gather, exact in
    every dtype, O(P*H*W) bytes moved."""
    return jnp.take(stacked, ancestors, axis=0)


class PFState(NamedTuple):
    logodds: jax.Array        # [P, H, W] per-particle maps
    poses: jax.Array          # [P, 3]
    log_w: jax.Array          # [P] log weights (normalized-ish)
    prev_odom: jax.Array      # [3]
    rng: jax.Array            # PRNG key
    dist: jax.Array           # scalar: cumulative odometry travel
    since_update: jax.Array   # scalar: travel since last map integration
    since_match: jax.Array    # scalar: travel since last refinement step


def fastslam_init(cfg: FrontendConfig, pf: PFConfig, rng, start_pose=None):
    pose = (
        jnp.zeros(3, jnp.float32)
        if start_pose is None
        else jnp.asarray(start_pose, jnp.float32)
    )
    P = pf.n_particles
    map_dtype = jnp.dtype(pf.map_dtype)
    return PFState(
        logodds=jnp.zeros((P, cfg.grid.height, cfg.grid.width), map_dtype),
        poses=jnp.tile(pose[None, :], (P, 1)),
        log_w=jnp.zeros(P, jnp.float32),
        prev_odom=pose + 0.0,
        rng=rng,
        dist=jnp.float32(0.0),
        since_update=jnp.float32(jnp.inf),  # force first-scan integration
        since_match=jnp.float32(0.0),
    )


def host_gate_flags(odom, cfg: FrontendConfig, prev_odom, dist0=0.0,
                    since_u0=0.0, since_m0=0.0):
    """Host mirror of fastslam_step's motion gates (all odometry-derived).

    Measured motivation (scripts/bench_pf1000_parts.py, P=1000 bf16): a
    scan where NO stage fires still cost 3.43 ms — the two lax.cond joins
    whose branches return the full [P, H, W] stack each force a full-stack
    copy on the identity path. The gates are pure functions of odometry,
    which the HOST streams in — so the host can decide per scan which
    stages fire and dispatch stage-specialized programs with no map-shaped
    cond at all (see run_fastslam's host-gated path).

    `prev_odom` is the record preceding odom[0] (the state's carried
    prev_odom — for fresh starts the driver sets it to odom[0], for
    resumed runs it is the previous segment's last record). Accumulators
    start from the (possibly checkpoint-restored) state's scalars.

    Returns [T, 3] bool (do_refine, do_update, in_boot)."""
    import numpy as np

    odom = np.asarray(odom, np.float32)
    T = len(odom)
    flags = np.zeros((T, 3), bool)
    dist = np.float32(dist0)
    su = np.float32(since_u0)
    sm = np.float32(since_m0)
    prev = np.asarray(prev_odom, np.float32)
    ratio = np.float32(cfg.match_min_motion / max(cfg.match_min_rot, 1e-6))
    for t in range(len(odom)):
        o = odom[t]
        dx, dy = o[0] - prev[0], o[1] - prev[1]
        # identical op set to se2.between: rotate into prev's frame first
        c, s = np.cos(prev[2], dtype=np.float32), np.sin(prev[2], dtype=np.float32)
        bx = c * dx + s * dy
        by = -s * dx + c * dy
        step_len = np.float32(np.hypot(bx, by))
        dth = np.float32((o[2] - prev[2] + np.pi) % (2 * np.pi) - np.pi)
        in_boot = bool(dist < cfg.bootstrap_dist)
        sm = np.float32(sm + step_len + np.abs(dth) * ratio)
        do_refine = (not in_boot) and bool(sm >= cfg.match_min_motion)
        if do_refine:
            sm = np.float32(0.0)
        su = np.float32(su + step_len)
        do_update = in_boot or bool(su >= cfg.map_update_min_motion)
        if do_update:
            su = np.float32(0.0)
        dist = np.float32(dist + step_len)
        flags[t] = (do_refine, do_update, in_boot)
        prev = o
    return flags


def _refine_all(state_logodds, ranges, priors, cfg, pf):
    """The refine computation shared by fastslam_step and the host-gated
    heavy step: (matched [P,3], scores [P])."""
    P = pf.n_particles
    mcfg = refine_matcher(cfg, pf)
    mode = _resolve_refine_mode(pf, mcfg)
    if mode == "shared":
        from slam2d_tpu.pf.shared_refine import shared_refine

        return shared_refine(state_logodds, ranges, priors, cfg, mcfg, pf)
    batched = jax.vmap(
        lambda g, p: _windowed_match(g, ranges, p, cfg, mcfg)
    )
    if pf.refine_chunk and P > pf.refine_chunk:
        assert P % pf.refine_chunk == 0, (P, pf.refine_chunk)
        nc = P // pf.refine_chunk
        Hg, Wg = state_logodds.shape[-2:]
        g_ = state_logodds.reshape(nc, pf.refine_chunk, Hg, Wg)
        p_ = priors.reshape(nc, pf.refine_chunk, 3)
        matched, scores = jax.lax.map(
            lambda args: batched(args[0], args[1]), (g_, p_)
        )
        return matched.reshape(P, 3), scores.reshape(P)
    return batched(state_logodds, priors)


def _update_all(logodds, poses, ranges, cfg, pf, rng=None):
    """The map-update computation shared by fastslam_step and the
    host-gated heavy step. PFConfig.update_mode picks the batching:
    shared-anchor images or the vmapped per-particle kernel. `rng` (the step's carried key, NOT consumed — a fold_in
    side-stream) feeds the optional carve anchor dither."""
    P = pf.n_particles
    mode = _resolve_update_mode(pf)
    if mode == "shared":
        from slam2d_tpu.pf.shared_update import shared_update

        dither_key = None
        if (rng is not None
                and getattr(pf, "update_anchor_dither", "off") != "off"):
            dither_key = jax.random.fold_in(rng, 0x0D17)
        return shared_update(
            logodds, poses, ranges, cfg, pf, dither_key=dither_key
        )
    if mode in ("quantized_per_particle", "quantized_theta_only",
                "quantized_xy_only"):
        # diagnostic A/B for the shared-update ATE gap: the EXACT
        # per-particle kernel at shared_update's quantized poses
        # (see shared_update.quantize_update_poses); the _only variants
        # quantize one axis to attribute the error
        from slam2d_tpu.pf.shared_update import quantize_update_poses

        poses = quantize_update_poses(
            poses, cfg, pf,
            q_xy=mode != "quantized_theta_only",
            q_theta=mode != "quantized_xy_only",
        )
    batched_upd = jax.vmap(lambda g, p: _windowed_update(g, p, ranges, cfg))
    if pf.refine_chunk and P > pf.refine_chunk:
        nc = P // pf.refine_chunk
        Hg, Wg = logodds.shape[-2:]
        g_ = logodds.reshape(nc, pf.refine_chunk, Hg, Wg)
        p_ = poses.reshape(nc, pf.refine_chunk, 3)
        out = jax.lax.map(
            lambda args: batched_upd(args[0], args[1]), (g_, p_)
        )
        return out.reshape(P, Hg, Wg)
    return batched_upd(logodds, poses)


@functools.cache
def make_heavy_step(cfg: FrontendConfig, pf: PFConfig, refine: bool,
                    update: bool, boot: bool):
    """Stage-specialized per-scan step for the host-gated driver: the
    motion gates are STATIC (host-decided), so no map-shaped lax.cond
    exists and the donated [P, H, W] stack updates in place. Only the
    resample trigger (a function of device data, n_eff) remains a cond."""
    P = pf.n_particles

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: PFState, odom, ranges):
        rng, k_noise, k_resample = jax.random.split(state.rng, 3)
        delta = se2.between(state.prev_odom, odom)
        step_len = jnp.hypot(delta[0], delta[1])
        rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
            cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
        )
        since_m = state.since_match + step_len + rot_equiv

        if refine:
            noise = jax.random.normal(k_noise, (P, 3)) * jnp.asarray(
                [pf.noise_xy, pf.noise_xy, pf.noise_theta], jnp.float32
            )
            priors = se2.compose(state.poses, delta[None, :] + noise)
            poses, scores = _refine_all(
                state.logodds, ranges, priors, cfg, pf
            )
            log_w = state.log_w + pf.weight_sharpness * scores
            log_w = log_w - jax.scipy.special.logsumexp(log_w)
            since_m = jnp.float32(0.0)
        elif boot:
            noise = jax.random.normal(k_noise, (P, 3)) * jnp.asarray(
                [pf.noise_xy, pf.noise_xy, pf.noise_theta], jnp.float32
            )
            poses = se2.compose(state.poses, delta[None, :] + noise)
            log_w = state.log_w
            scores = jnp.full((P,), -1.0, jnp.float32)
        else:
            poses = se2.compose(state.poses, delta[None, :])
            log_w = state.log_w
            scores = jnp.full((P,), -1.0, jnp.float32)

        since = state.since_update + step_len
        if update:
            logodds = _update_all(state.logodds, poses, ranges, cfg, pf,
                                   rng=state.rng)
            since = jnp.float32(0.0)
        else:
            logodds = state.logodds

        n_eff = effective_sample_size(log_w)
        if refine:
            do_resample = n_eff < pf.resample_threshold * P

            def resample_branch(args):
                lo, po, lw = args
                u = jax.random.uniform(k_resample)
                ancestors = systematic_ancestors(lw, u)
                return (
                    _resample_copy(lo, ancestors),
                    po[ancestors],
                    jnp.full((P,), -jnp.log(P), lw.dtype),
                )

            logodds, poses, log_w = jax.lax.cond(
                do_resample, resample_branch, lambda a: a,
                (logodds, poses, log_w),
            )

        best = jnp.argmax(log_w)
        dist = state.dist + step_len
        new_state = PFState(
            logodds, poses, log_w, odom, rng, dist, since, since_m
        )
        return new_state, (poses[best], n_eff, scores[best])

    return step


@functools.cache
def make_heavy_step_fused(cfg: FrontendConfig, pf: PFConfig, refine: bool,
                          update: bool, boot: bool, L: int):
    """Heavy step with up to L dead-reckoning PRE-scans fused in front.

    The host-gated driver's stage cadence at P=1000 is ~one heavy event
    per 3 scans with 1-5 light scans between; dispatching the lights
    separately costs one more dispatch per segment on top of the heavy
    one (scripts/bench_heavy_step.py measures the floor). Fusing the
    prefix halves the dispatch count.

    Contract: odom_seg is [L+1, 3] — slots [L - n_pre, L) hold the light
    scans (in order), slots before them repeat the carried prev_odom
    (identical consecutive records = no-op motion), slot L is the heavy
    scan. The RNG stream replicates the unfused driver exactly: one
    masked 3-way split per REAL light slot, then the heavy step's split —
    fused and unfused host-gated runs are bit-identical.

    Returns (state, (bp [L+1, 3] per-slot best pose, n_eff_pre — the
    entry-weights N_eff the unfused light chunks would have reported,
    n_eff, score))."""
    P = pf.n_particles
    step = make_heavy_step(cfg, pf, refine, update, boot)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def fused(state: PFState, odom_seg, ranges, n_pre):
        best = jnp.argmax(state.log_w)
        n_eff0 = effective_sample_size(state.log_w)

        def body(c, inp):
            i, o = inp
            poses, rng, prev, dist, su, sm = c
            real = i >= L - n_pre
            rng2, _, _ = jax.random.split(rng, 3)
            rng = jnp.where(real, rng2, rng)
            delta = se2.between(prev, o)
            step_len = jnp.hypot(delta[0], delta[1])
            rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
                cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
            )
            # padded slots must be EXACT no-ops: compose wraps theta, and
            # a wrap of an unwrapped carry perturbs it at f32 ulp — enough
            # to flip boundary cells in later map updates
            poses = jnp.where(real, se2.compose(poses, delta[None, :]), poses)
            step_len = jnp.where(real, step_len, 0.0)
            rot_equiv = jnp.where(real, rot_equiv, 0.0)
            c2 = (poses, rng, o, dist + step_len, su + step_len,
                  sm + step_len + rot_equiv)
            return c2, poses[best]

        (poses, rng, prev, dist, su, sm), bp_pre = jax.lax.scan(
            body,
            (state.poses, state.rng, state.prev_odom, state.dist,
             state.since_update, state.since_match),
            (jnp.arange(L, dtype=jnp.int32), odom_seg[:L]),
        )
        state = state._replace(
            poses=poses, rng=rng, prev_odom=prev, dist=dist,
            since_update=su, since_match=sm,
        )
        state, (bp_h, n_eff, sc) = step(state, odom_seg[L], ranges)
        return state, (
            jnp.concatenate([bp_pre, bp_h[None]]), n_eff0, n_eff, sc
        )

    return fused


@functools.cache
def make_light_chunk(cfg: FrontendConfig, pf: PFConfig, seg_len: int):
    """Dead-reckoning run over up to seg_len consecutive NO-STAGE scans:
    carries ONLY the small state (the map stack is never an argument, so
    light scans cost zero memory traffic on it). Padded records (i >= n_valid,
    repeats of the last odom) are natural no-ops except the RNG split,
    which is masked so the stream matches the ungated step exactly."""

    @jax.jit
    def run(poses, log_w, rng, prev_odom, dist, since_u, since_m,
            odom_seg, n_valid):
        best = jnp.argmax(log_w)
        n_eff = effective_sample_size(log_w)

        def body(c, inp):
            i, o = inp
            poses, rng, prev, dist, su, sm = c
            real = i < n_valid
            rng2, _, _ = jax.random.split(rng, 3)
            rng = jnp.where(real, rng2, rng)
            delta = se2.between(prev, o)
            step_len = jnp.hypot(delta[0], delta[1])
            rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
                cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
            )
            # padded slots must be EXACT no-ops (match make_heavy_step_fused):
            # compose wraps theta, and a wrap of an unwrapped carry perturbs
            # it at f32 ulp even for an identity delta — enough to diverge
            # from the fused path once resampling amplifies it
            poses = jnp.where(real, se2.compose(poses, delta[None, :]), poses)
            step_len = jnp.where(real, step_len, 0.0)
            rot_equiv = jnp.where(real, rot_equiv, 0.0)
            c2 = (poses, rng, o, dist + step_len, su + step_len,
                  sm + step_len + rot_equiv)
            return c2, poses[best]

        (poses, rng, prev, dist, su, sm), bp = jax.lax.scan(
            body,
            (poses, rng, prev_odom, dist, since_u, since_m),
            (jnp.arange(seg_len, dtype=jnp.int32), odom_seg),
        )
        return poses, rng, prev, dist, su, sm, bp, n_eff

    return run


def pf_state_template(cfg: FrontendConfig, pf: PFConfig) -> PFState:
    """Host (numpy) PFState with the run's shapes/dtypes — the checkpoint
    restore target (SURVEY.md §7 "particle state"). Never touches a device:
    at P=1000 the [P, H, W] map stack must not be staged on one device just
    to describe its shape."""
    import numpy as np

    key = jax.eval_shape(lambda: jax.random.PRNGKey(0))
    P = pf.n_particles
    return PFState(
        logodds=np.zeros(
            (P, cfg.grid.height, cfg.grid.width), jnp.dtype(pf.map_dtype)
        ),
        poses=np.zeros((P, 3), np.float32),
        log_w=np.zeros(P, np.float32),
        prev_odom=np.zeros(3, np.float32),
        rng=np.zeros(key.shape, key.dtype),
        dist=np.float32(0.0),
        since_update=np.float32(0.0),
        since_match=np.float32(0.0),
    )


def effective_sample_size(log_w):
    w = jax.nn.softmax(log_w)
    return 1.0 / jnp.sum(w * w)


def systematic_ancestors(log_w, u):
    """Low-variance (systematic) resampling ancestor indices.

    One uniform u ~ U[0,1); ancestor k chosen where (u + k)/P falls in the
    normalized-weight CDF. Returns int32 [P].
    """
    P = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cdf = jnp.cumsum(w)
    pts = (u + jnp.arange(P, dtype=jnp.float32)) / P
    return jnp.clip(
        jnp.searchsorted(cdf, pts, side="left"), 0, P - 1
    ).astype(jnp.int32)


def fastslam_step(state: PFState, odom, ranges, cfg: FrontendConfig, pf: PFConfig):
    """One scan for all particles. Returns (state, (best_pose, n_eff, best_score)).

    FastSLAM-2.0-flavored proposal: each particle refines its odometry+noise
    proposal with a correlative match against its OWN map (SURVEY.md §4.3
    step 2); the match score doubles as the likelihood-field weight update.

    Refinement (the expensive per-particle matching + weighting + possible
    resample) is motion-gated like the frontend's matcher: between
    refinement steps all particles dead-reckon on odometry and the heavy
    branch costs nothing (`lax.cond`). Proposal noise is injected once per
    REFINEMENT, which keeps the cloud spread tied to travel rather than to
    the log's scan rate.
    """
    P = pf.n_particles
    rng, k_noise, k_resample = jax.random.split(state.rng, 3)

    delta = se2.between(state.prev_odom, odom)
    step_len = jnp.hypot(delta[0], delta[1])
    in_boot = state.dist < cfg.bootstrap_dist
    rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
        cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
    )
    since_m = state.since_match + step_len + rot_equiv
    do_refine = (~in_boot) & (since_m >= cfg.match_min_motion)

    def refine_branch(_):
        noise = jax.random.normal(k_noise, (P, 3)) * jnp.asarray(
            [pf.noise_xy, pf.noise_xy, pf.noise_theta], jnp.float32
        )
        priors = se2.compose(state.poses, delta[None, :] + noise)
        matched, scores = _refine_all(state.logodds, ranges, priors, cfg, pf)
        # log-space likelihood-field weights; the softmax-normalization
        # makes the additive offset of the score range irrelevant
        log_w = state.log_w + pf.weight_sharpness * scores
        log_w = log_w - jax.scipy.special.logsumexp(log_w)
        return matched, log_w, scores

    def deadreckon_branch(_):
        # during bootstrap: noisy propagation builds particle diversity
        noise = jax.random.normal(k_noise, (P, 3)) * jnp.asarray(
            [pf.noise_xy, pf.noise_xy, pf.noise_theta], jnp.float32
        )
        d = jnp.where(in_boot, delta[None, :] + noise, delta[None, :])
        poses = se2.compose(state.poses, d)
        return poses, state.log_w, jnp.full((P,), -1.0, jnp.float32)

    poses, log_w, scores = jax.lax.cond(
        do_refine, refine_branch, deadreckon_branch, None
    )
    since_m = jnp.where(do_refine, 0.0, since_m)

    # --- map update (motion-filtered, like the frontend) --------------------
    since = state.since_update + step_len
    do_update = in_boot | (since >= cfg.map_update_min_motion)

    def update_branch(_):
        # chunked like the refinement when refine_chunk is set
        return _update_all(state.logodds, poses, ranges, cfg, pf,
                           rng=state.rng)

    logodds = jax.lax.cond(
        do_update, update_branch, lambda _: state.logodds, None
    )
    since = jnp.where(do_update, 0.0, since)

    # --- resample on N_eff trigger (only meaningful after a refinement) ----
    n_eff = effective_sample_size(log_w)
    do_resample = do_refine & (n_eff < pf.resample_threshold * P)

    def resample_branch(args):
        logodds, poses, log_w = args
        u = jax.random.uniform(k_resample)
        ancestors = systematic_ancestors(log_w, u)
        return (
            _resample_copy(logodds, ancestors),
            poses[ancestors],
            jnp.full((P,), -jnp.log(P), log_w.dtype),
        )

    logodds, poses, log_w = jax.lax.cond(
        do_resample, resample_branch, lambda a: a, (logodds, poses, log_w)
    )

    best = jnp.argmax(log_w)
    best_pose = poses[best]
    best_score = scores[best]
    dist = state.dist + step_len

    new_state = PFState(logodds, poses, log_w, odom, rng, dist, since, since_m)
    return new_state, (best_pose, n_eff, best_score)
