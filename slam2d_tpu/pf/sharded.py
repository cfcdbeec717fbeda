"""Device-sharded FastSLAM (SURVEY.md §4.3 distributed form, config 4).

Particles are split across devices with `shard_map` over a ("particles",)
mesh axis. Per-scan collectives:

- weight normalization / N_eff: one packed `all_gather` of per-shard
  (max, sum, sum-of-squares) stats (a max-subtracted logsumexp).
- systematic resampling: `all_gather` of the (tiny) per-particle log-weights
  gives every shard the global CDF; each shard computes the same global
  ancestor indices from a shared uniform draw.
- cross-shard particle-map migration: a ring exchange over `ppermute`. Each
  shard's [Pl, H*W] map block circulates the ring; at every hop each output
  slot whose ancestor lives in the passing block copies that row (a row
  gather + select — exact in every dtype). After at most n_shards hops
  every output slot holds its ancestor's map. Peak memory stays at ONE
  local block (no [P, H, W] all_gather). The whole ring sits
  behind a `lax.cond` on the N_eff trigger: the predicate comes from psum'd
  quantities, so every shard takes the same branch and the collective is
  SPMD-safe — non-resampling steps pay nothing.

RNG: every shard holds the same key; per-particle proposal noise comes from
folding the shard index in, the resampling uniform uses the shared key so
all shards agree on the global ancestors.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam2d_tpu.config import FrontendConfig, PFConfig
from slam2d_tpu.core import se2
from slam2d_tpu.parallel.mesh import PARTICLE_AXIS
from slam2d_tpu.pf.fastslam import (
    PFState,
    _refine_all,
    _update_all,
    systematic_ancestors,
)


def sharded_state_sharding(mesh: Mesh, axis: str = PARTICLE_AXIS):
    """NamedShardings for a PFState: particle-major arrays sharded, rest replicated."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    return PFState(
        logodds=s(axis, None, None),
        poses=s(axis, None),
        log_w=s(axis),
        prev_odom=s(None),
        rng=s(None),
        dist=s(),
        since_update=s(),
        since_match=s(),
    )


def place_state(state: PFState, mesh: Mesh, axis: str = PARTICLE_AXIS) -> PFState:
    sh = sharded_state_sharding(mesh, axis)
    return jax.tree.map(jax.device_put, state, sh)


def sharded_fastslam_init(
    cfg: FrontendConfig, pf: PFConfig, rng, mesh: Mesh, start_pose=None
):
    import numpy as np

    # Build leaves on the HOST and let device_put shard directly — calling
    # fastslam_init would stage the whole [P, H, W] stack on one device
    # before resharding (an avoidable memory spike at large P).
    pose = (
        np.zeros(3, np.float32)
        if start_pose is None
        else np.asarray(start_pose, np.float32)
    )
    P_ = pf.n_particles
    map_dtype = jnp.dtype(pf.map_dtype)
    host = PFState(
        logodds=np.zeros((P_, cfg.grid.height, cfg.grid.width), map_dtype),
        poses=np.tile(pose[None, :], (P_, 1)),
        log_w=np.zeros(P_, np.float32),
        prev_odom=pose.copy(),
        rng=rng,
        dist=np.float32(0.0),
        since_update=np.float32(np.inf),
        since_match=np.float32(0.0),
    )
    return place_state(host, mesh)


def _global_log_normalize(log_w, axis):
    """Normalize log-weights across all shards; returns (log_w, n_eff).

    ONE collective (VERDICT r4 item 5 — this chain was three SEQUENTIAL
    scalar collectives: pmax(max), psum(Z), psum(sum w^2), 3629 us/step
    at the production cadence, the top cost in the per-collective probe):
    each shard packs its local (max, sum exp(lw-max), sum exp(2(lw-max)))
    into a [3]-vector and a single tiny all_gather replicates all shard
    stats; the global logsumexp and N_eff = Z^2/S2 reassemble locally,
    bit-identically up to f32 reassociation of the shard partials. A
    collective this small is latency-bound, not size-bound, so [S,3]
    floats cost the same as one scalar psum."""
    # a dead shard (all -inf weights) must contribute 0, not NaN:
    # keep the local max finite so exp(-inf - m_loc) == 0
    m_loc = jnp.maximum(jnp.max(log_w), jnp.float32(-1e30))
    e = jnp.exp(log_w - m_loc)
    packed = jnp.stack([m_loc, jnp.sum(e), jnp.sum(e * e)])
    stats = jax.lax.all_gather(packed, axis)          # [n_shards, 3]
    m = jnp.max(stats[:, 0])
    sc = jnp.exp(stats[:, 0] - m)
    z = jnp.sum(stats[:, 1] * sc)
    s2 = jnp.sum(stats[:, 2] * sc * sc)
    log_w = log_w - m - jnp.log(z)
    n_eff = (z * z) / s2
    return log_w, n_eff


def make_sharded_step(cfg: FrontendConfig, pf: PFConfig, mesh: Mesh,
                      axis: str = PARTICLE_AXIS, gates=None,
                      carry_n_eff: bool = False,
                      ring_stats: bool = False):
    """Build the shard_map'ped per-scan step function.

    gates: None keeps the dynamic lax.cond stage gating (the single-
    program chunk form). A (refine, update, boot) bool tuple makes the
    gates STATIC for the host-gated driver — stage-specialized programs
    with no map-shaped cond joins, exactly like pf/fastslam.py's
    make_heavy_step (the gates are odometry-derived, identical on every
    shard, so the host can decide them). The data-dependent resample
    trigger stays a lax.cond either way.

    carry_n_eff (ungated form only): the step takes a 4th replicated
    argument n_eff_prev and skips the weight-normalization collectives
    on no-refine scans (weights are unchanged there, so the psum/pmax
    recompute a constant — at the production cadence that was 3 scalar
    collectives per scan for ~1 refine in 3; VERDICT r3 item 4). The
    chunk driver seeds the carry with one normalize per chunk."""
    n_shards = mesh.shape[axis]
    P_total = pf.n_particles
    assert P_total % n_shards == 0, (
        f"n_particles={P_total} must divide over {n_shards} shards"
    )
    Pl = P_total // n_shards

    def step(state: PFState, odom, ranges, *extra):
        """Runs per-shard: particle-major inputs are the local [Pl, ...] block."""
        shard = jax.lax.axis_index(axis)
        rng, k_step = jax.random.split(state.rng)
        k_local = jax.random.fold_in(k_step, shard)

        delta = se2.between(state.prev_odom, odom)
        step_len = jnp.hypot(delta[0], delta[1])

        noise = jax.random.normal(k_local, (Pl, 3)) * jnp.asarray(
            [pf.noise_xy, pf.noise_xy, pf.noise_theta], jnp.float32
        )
        priors = se2.compose(state.poses, delta[None, :] + noise)

        rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
            cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
        )
        since_m = state.since_match + step_len + rot_equiv
        if gates is None:
            in_boot = state.dist < cfg.bootstrap_dist
            do_refine = (~in_boot) & (since_m >= cfg.match_min_motion)
        else:
            g_refine, g_update, g_boot = gates
            in_boot = jnp.bool_(g_boot)
            do_refine = jnp.bool_(g_refine)

        # Heavy per-particle matching behind lax.cond — the predicate is a
        # function of replicated scalars, so every shard takes the same
        # branch (SPMD-safe) and non-refine scans pay nothing.
        # pf_local: the per-shard batching (refine_chunk) resolves on the
        # LOCAL particle count Pl — static and identical on every shard,
        # so stage structure is SPMD-safe.
        pf_local = dataclasses.replace(pf, n_particles=Pl)

        def refine_branch(_):
            return _refine_all(state.logodds, ranges, priors, cfg, pf_local)

        def skip_match(_):
            return priors, jnp.full((Pl,), -1.0, jnp.float32)

        if gates is None:
            matched, scores = jax.lax.cond(
                do_refine, refine_branch, skip_match, None
            )
        else:
            matched, scores = (
                refine_branch(None) if g_refine else skip_match(None)
            )

        # boot: noisy propagation for diversity; between refinements:
        # noiseless dead-reckoning; refinement: matched pose
        deadreckon = jnp.where(
            in_boot, priors, se2.compose(state.poses, delta[None, :])
        )
        poses = jnp.where(do_refine, matched, deadreckon)
        since_m = jnp.where(do_refine, 0.0, since_m)

        log_w = state.log_w + jnp.where(
            do_refine, pf.weight_sharpness * scores, 0.0
        )
        if carry_n_eff and gates is None:
            # weights only change on refine scans; skip the pmax/psum
            # normalize otherwise and reuse the carried n_eff (identical
            # value — the weights it was computed from are unchanged)
            log_w, n_eff = jax.lax.cond(
                do_refine,
                lambda lw: _global_log_normalize(lw, axis),
                lambda lw: (lw, extra[0]),
                log_w,
            )
        else:
            log_w, n_eff = _global_log_normalize(log_w, axis)

        since = state.since_update + step_len
        do_update = in_boot | (since >= cfg.map_update_min_motion)
        # shard-local update batching on the LOCAL particle count (static,
        # via pf_local above): every shard takes the same branch
        if gates is None:
            logodds = jax.lax.cond(
                do_update,
                lambda _: _update_all(
                    state.logodds, poses, ranges, cfg, pf_local,
                    rng=state.rng,
                ),
                lambda _: state.logodds,
                None,
            )
            since = jnp.where(do_update, 0.0, since)
        elif g_update:
            logodds = _update_all(state.logodds, poses, ranges, cfg,
                                   pf_local, rng=state.rng)
            since = jnp.float32(0.0)
        else:
            logodds = state.logodds

        # ---- global systematic resampling ---------------------------------
        if gates is not None and not g_refine:
            # resampling only triggers on refine scans (weights unchanged
            # otherwise); the static no-refine programs skip the whole
            # resample graph — no ancestor collectives, no map-shaped cond
            dist = state.dist + step_len
            new_state = PFState(
                logodds, poses, log_w, odom, rng, dist, since, since_m
            )
            best_local = jnp.argmax(log_w)
            # ONE packed all_gather for (weight, pose): per-step gathers
            # are latency-bound, so fold the candidates into one launch
            cand = jax.lax.all_gather(
                jnp.concatenate(
                    [log_w[best_local][None], poses[best_local]]
                ),
                axis,
            )                                               # [n_shards, 4]
            b = jnp.argmax(cand[:, 0])
            return new_state, (
                cand[b, 1:4], n_eff, jnp.float32(-1.0)
            )
        do_resample = do_refine & (n_eff < pf.resample_threshold * P_total)
        u = jax.random.uniform(jax.random.fold_in(k_step, 10_000_019))
        local_slots = shard * Pl + jnp.arange(Pl, dtype=jnp.int32)

        # The CDF + pose all_gathers only matter when the trigger fired:
        # gate them with the same SPMD-safe replicated-predicate cond as
        # the ring (n_eff is psum-derived, identical on every shard), so
        # non-resample scans pay no ancestor collectives at all.
        def gather_ancestors(_):
            log_w_all = jax.lax.all_gather(log_w, axis, tiled=True)
            ancestors = systematic_ancestors(log_w_all, u)     # [P] global
            want = ancestors[local_slots]                      # [Pl] global
            poses_all = jax.lax.all_gather(poses, axis, tiled=True)
            return want, poses_all[want]

        idx, poses_new = jax.lax.cond(
            do_resample, gather_ancestors,
            lambda _: (local_slots, poses), None,
        )

        # Maps are big: ring exchange over ppermute, but ONLY when the
        # N_eff trigger fired. The predicate is identical on every shard
        # (derived from psum'd quantities), so gating the collective with
        # lax.cond is SPMD-safe: all shards take the same branch.
        H, W = cfg.grid.height, cfg.grid.width
        maps_flat = logodds.reshape(Pl, H * W)
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

        def ring_exchange(maps_flat):
            # Ancestor-distance-bounded ring (SURVEY §9 "exchange ancestor
            # indices, copy maps lazily"): hop k delivers blocks from ring
            # distance k, and systematic ancestors cluster near their own
            # shard (most rows survive locally), so the pmax'd maximum
            # needed distance — usually 0 or 1 — bounds the live hops. The
            # previous static unroll shipped the full per-shard map stack
            # n_shards-1 times between devices on every trigger regardless of
            # need. The trip bound is a pmax-replicated scalar, so the
            # dynamic while_loop takes the same trips on every shard
            # (SPMD-safe, like the do_resample cond above).
            k_need = jnp.mod(shard - idx // Pl, n_shards)      # [Pl]
            d_max = jax.lax.pmax(jnp.max(k_need), axis)

            def take_from(k, blk, out):
                # rows whose ancestor lives in the block from ring
                # distance k copy it; each output row matches exactly one
                # hop, so the result is a bit-exact copy
                src_shard = jnp.mod(shard - k, n_shards)
                local = idx - src_shard * Pl
                here = (local >= 0) & (local < Pl)
                rows = jnp.take(blk, jnp.clip(local, 0, Pl - 1), axis=0)
                return jnp.where(here[:, None], rows, out)

            def body(c):
                k, blk, out = c
                blk = jax.lax.ppermute(blk, axis, perm)
                return k + 1, blk, take_from(k, blk, out)

            _, _, out = jax.lax.while_loop(
                lambda c: c[0] <= d_max,
                body,
                (jnp.int32(1), maps_flat,
                 take_from(0, maps_flat, maps_flat)),
            )
            return out

        maps_new = jax.lax.cond(
            do_resample, ring_exchange, lambda m: m, maps_flat
        ).reshape(Pl, H, W)

        log_w_new = jnp.where(
            do_resample,
            jnp.full((Pl,), -jnp.log(P_total), log_w.dtype),
            log_w,
        )

        # best particle (global argmax) for trajectory reporting — ONE
        # packed all_gather of (weight, pose, score) instead of three
        # (per-step small gathers are latency-bound; VERDICT r3 item 4)
        best_local = jnp.argmax(log_w)
        cand = jax.lax.all_gather(
            jnp.concatenate(
                [log_w[best_local][None], poses[best_local],
                 scores[best_local][None]]
            ),
            axis,
        )                                                   # [n_shards, 5]
        b = jnp.argmax(cand[:, 0])
        best_pose = cand[b, 1:4]
        best_score = cand[b, 4]

        dist = state.dist + step_len
        new_state = PFState(
            maps_new, poses_new, log_w_new, odom, rng, dist, since, since_m
        )
        if ring_stats:
            # per-particle ancestor ring distance (0 when no resample
            # fired) — bench_scaling's d_max histogram (VERDICT r3 item 4)
            k_need = jnp.mod(shard - idx // Pl, n_shards).astype(jnp.int32)
            return new_state, (best_pose, n_eff, best_score, k_need)
        if carry_n_eff and gates is None:
            # 4th output = the n_eff to CARRY into the next scan: a
            # resample resets the weights to uniform, so the carried
            # value must be P_total, not the pre-resample n_eff (the
            # reported per-scan n_eff stays the pre-resample value, as
            # the unsharded path reports it)
            ne_carry = jnp.where(
                do_resample, jnp.float32(P_total), n_eff
            )
            return new_state, (best_pose, n_eff, best_score, ne_carry)
        return new_state, (best_pose, n_eff, best_score)

    state_specs = PFState(
        logodds=P(axis, None, None),
        poses=P(axis, None),
        log_w=P(axis),
        prev_odom=P(None),
        rng=P(None),
        dist=P(),
        since_update=P(),
        since_match=P(),
    )
    assert not (ring_stats and gates is not None), (
        "ring_stats is only wired for the ungated step form"
    )
    assert not (ring_stats and carry_n_eff), (
        "ring_stats and carry_n_eff use the same 4th output slot"
    )
    out_specs = (state_specs, (P(None), P(), P()))
    if ring_stats:
        out_specs = (state_specs, (P(None), P(), P(), P(axis)))

    in_specs = (state_specs, P(None), P(None))
    if carry_n_eff and gates is None:
        in_specs = in_specs + (P(),)
        out_specs = (state_specs, (P(None), P(), P(), P()))
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return sharded


@functools.cache
def make_sharded_chunk_fn(cfg: FrontendConfig, pf: PFConfig, mesh: Mesh,
                          axis: str = PARTICLE_AXIS):
    """Jitted lax.scan over the sharded step for a [K, ...] chunk of scans.

    The n_eff carry (one normalize per chunk seeds it; refine scans
    refresh it, resamples reset it to P) lets the step skip the weight
    collectives on no-refine scans — see
    make_sharded_step(carry_n_eff=True). functools.cache'd: fresh jit
    closures per driver call re-trace AND re-XLA-compile (CLAUDE.md
    factory rule)."""
    step = make_sharded_step(cfg, pf, mesh, axis, carry_n_eff=True)

    norm = jax.shard_map(
        lambda lw: _global_log_normalize(lw, axis)[1],
        mesh=mesh, in_specs=P(axis), out_specs=P(),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk_fn(state: PFState, odom_chunk, ranges_chunk):
        ne0 = norm(state.log_w)

        def body(c, inp):
            s, ne = c
            o, r = inp
            s, out = step(s, o, r, ne)
            return (s, out[3]), out[:3]

        (state, _), outs = jax.lax.scan(
            body, (state, ne0), (odom_chunk, ranges_chunk)
        )
        return state, outs

    return chunk_fn


@functools.cache
def make_sharded_heavy_step(cfg: FrontendConfig, pf: PFConfig, mesh: Mesh,
                            refine: bool, update: bool, boot: bool,
                            axis: str = PARTICLE_AXIS):
    """Stage-specialized sharded step for the host-gated driver (the
    sharded analog of pf/fastslam.py make_heavy_step): motion gates are
    static, only the n_eff resample trigger remains a cond."""
    step = make_sharded_step(
        cfg, pf, mesh, axis, gates=(bool(refine), bool(update), bool(boot))
    )
    return jax.jit(step, donate_argnums=(0,))


@functools.cache
def make_sharded_light_chunk(cfg: FrontendConfig, pf: PFConfig, mesh: Mesh,
                             seg_len: int, axis: str = PARTICLE_AXIS):
    """Sharded dead-reckoning run over up to seg_len NO-STAGE scans — the
    sharded analog of pf/fastslam.py make_light_chunk. The map stack is
    never an argument; the best particle is resolved globally once per
    segment (weights don't change on light scans). RNG consumes one
    split per valid scan, matching the ungated sharded step's stream."""

    def run(poses, log_w, rng, prev_odom, dist, since_u, since_m,
            odom_seg, n_valid):
        _, n_eff = _global_log_normalize(log_w, axis)
        best_local = jnp.argmax(log_w)
        cand_w = jax.lax.all_gather(log_w[best_local], axis)
        b = jnp.argmax(cand_w)

        def body(c, inp):
            i, o = inp
            poses, rng, prev, dist, su, sm = c
            rng2, _ = jax.random.split(rng)
            rng = jnp.where(i < n_valid, rng2, rng)
            delta = se2.between(prev, o)
            step_len = jnp.hypot(delta[0], delta[1])
            rot_equiv = jnp.abs(se2.wrap_angle(delta[2])) * (
                cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
            )
            poses = se2.compose(poses, delta[None, :])
            c2 = (poses, rng, o, dist + step_len, su + step_len,
                  sm + step_len + rot_equiv)
            return c2, poses[best_local]

        (poses, rng, prev, dist, su, sm), bp_local = jax.lax.scan(
            body,
            (poses, rng, prev_odom, dist, since_u, since_m),
            (jnp.arange(seg_len, dtype=jnp.int32), odom_seg),
        )
        bp = jax.lax.all_gather(bp_local, axis)[b]        # [seg, 3]
        return poses, rng, prev, dist, su, sm, bp, n_eff

    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(None), P(None), P(), P(), P(),
                  P(None, None), P()),
        out_specs=(P(axis, None), P(None), P(None), P(), P(), P(),
                   P(None, None), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
