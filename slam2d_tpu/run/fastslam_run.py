"""FastSLAM driver (SURVEY.md §5.2, config 3): host streams chunks, device
runs `lax.scan` over jitted vmapped particle steps.

Two execution strategies:

- HOST-GATED (default at >= PFConfig.host_gate_min_particles): the
  motion gates are pure functions of odometry,
  which the host streams in — so the host decides per scan which stages
  fire and dispatches stage-specialized programs (make_heavy_step) plus a
  dead-reckoning run (make_light_chunk) that never touches the map stack.
  Measured motivation at P=1000 bf16 512² (scripts/bench_pf1000_parts.py):
  the ungated step's two map-shaped lax.cond joins cost 3.43 ms/scan even
  when NOTHING fires (a full-stack copy per identity join). Dispatches
  pipeline (no blocking fetches), so the extra per-scan dispatch count is
  host-side enqueue cost only.
- UNGATED (host_gated=False): one jitted lax.scan chunk with lax.cond
  gates — the sharded driver's structure (where gates must be SPMD-safe
  replicated predicates), kept for comparison and as the shard_map form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import FrontendConfig, PFConfig
from slam2d_tpu.pf.fastslam import (
    PFState,
    fastslam_init,
    fastslam_step,
    host_gate_flags,
    make_heavy_step,
    make_heavy_step_fused,
    make_light_chunk,
)


@functools.cache
def make_pf_chunk_fn(cfg: FrontendConfig, pf: PFConfig):
    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk_fn(state: PFState, odom_chunk, ranges_chunk):
        def body(s, inp):
            o, r = inp
            s2, out = fastslam_step(s, o, r, cfg, pf)
            return s2, out

        state, outs = jax.lax.scan(body, state, (odom_chunk, ranges_chunk))
        return state, outs

    return chunk_fn


LIGHT_SEG = 16   # static length of the dead-reckoning light run


def _run_fastslam_host_gated(odom, ranges, cfg, pf, state, frame_cb,
                             heavy_factory=None, light_factory=None):
    """Host-gated execution (module docstring). Stage patterns are decided
    from odometry on the host; the step programs carry no map-shaped cond.

    heavy_factory(refine, update, boot) / light_factory(seg_len) default
    to the single-device step builders; run_sharded_fastslam passes the
    shard_map'd equivalents (the gates are odometry-derived and identical
    on every shard, so the same host loop drives both).

    Single-device runs additionally FUSE up to pf.fuse_light_prefix
    dead-reckoning scans into the front of each heavy dispatch
    (make_heavy_step_fused): every dispatch costs a host-side floor
    regardless of its device work, and at the production cadence (heavy
    every ~3 scans) the separate light segments were one extra floor per
    heavy event. Bit-identical outputs (same RNG op
    sequence); custom factories (the sharded driver) keep the unfused
    loop."""
    fuse_L = (
        int(getattr(pf, "fuse_light_prefix", 0))
        if heavy_factory is None and light_factory is None
        else 0
    )
    if heavy_factory is None:
        heavy_factory = lambda r, u, b: make_heavy_step(cfg, pf, r, u, b)
    if light_factory is None:
        light_factory = lambda n: make_light_chunk(cfg, pf, n)
    T = len(odom)
    # gate accumulators from the (possibly restored) state: one fetch
    dist0, su0, sm0, prev0 = jax.device_get(
        (state.dist, state.since_update, state.since_match, state.prev_odom)
    )
    flags = host_gate_flags(odom, cfg, prev0, dist0, su0, sm0)
    light_fn = light_factory(LIGHT_SEG)

    bps, nes, scs = [], [], []
    frame_buf: list = []   # host rows awaiting the next frame (opt-in cost)

    def emit_frame_maybe(latest):
        if frame_cb is None:
            return
        frame_buf.append(np.atleast_2d(np.asarray(latest)))
        if sum(len(x) for x in frame_buf) >= cfg.chunk:
            best_map = jnp.take(
                state.logodds, jnp.argmax(state.log_w), axis=0
            )
            frame_cb(best_map, np.concatenate(frame_buf))
            frame_buf.clear()

    def dispatch_light(t, n):
        nonlocal state
        seg = odom[t : t + n]
        if n < LIGHT_SEG:
            seg = np.concatenate(
                [seg, np.repeat(seg[-1:], LIGHT_SEG - n, axis=0)]
            )
        poses, rng, prev, dist, su, sm, bp, ne = light_fn(
            state.poses, state.log_w, state.rng, state.prev_odom,
            state.dist, state.since_update, state.since_match,
            jnp.asarray(seg), jnp.int32(n),
        )
        state = state._replace(
            poses=poses, rng=rng, prev_odom=prev, dist=dist,
            since_update=su, since_match=sm,
        )
        bps.append(bp[:n])
        nes.append(jnp.full((n,), 1.0, jnp.float32) * ne)
        scs.append(jnp.full((n,), -1.0, jnp.float32))
        emit_frame_maybe(bps[-1])

    def dispatch_fused(t, n):
        # n light scans at [t, t+n) fused ahead of the heavy scan at t+n
        nonlocal state, prev_host
        h = t + n
        do_refine, do_update, in_boot = flags[h]
        seg = np.empty((fuse_L + 1, 3), np.float32)
        seg[: fuse_L - n] = prev_host
        seg[fuse_L - n : fuse_L] = odom[t:h]
        seg[fuse_L] = odom[h]
        fused = make_heavy_step_fused(
            cfg, pf, bool(do_refine), bool(do_update), bool(in_boot),
            fuse_L,
        )
        state, (bp, ne0, ne, sc) = fused(
            state, jnp.asarray(seg), jnp.asarray(ranges[h]), jnp.int32(n)
        )
        bps.append(bp[fuse_L - n :])
        nes.append(jnp.concatenate(
            [jnp.full((n,), 1.0, jnp.float32) * ne0, ne[None]]
        ))
        scs.append(jnp.concatenate(
            [jnp.full((n,), -1.0, jnp.float32), sc[None]]
        ))
        emit_frame_maybe(bps[-1])
        prev_host = odom[h]

    prev_host = np.asarray(prev0, np.float32)
    t = 0
    while t < T:
        do_refine, do_update, in_boot = flags[t]
        heavy_here = do_refine or do_update or in_boot
        if fuse_L > 0 and not heavy_here:
            # light run starting at t: fuse its tail (up to fuse_L scans)
            # into the next heavy dispatch; overflow and trailing runs go
            # out as standalone light segments
            n = 1
            while t + n < T and not flags[t + n].any():
                n += 1
            if t + n >= T:
                while n > 0:
                    m = min(LIGHT_SEG, n)
                    dispatch_light(t, m)
                    t += m
                    n -= m
                continue
            while n > fuse_L:
                m = min(LIGHT_SEG, n - fuse_L)
                dispatch_light(t, m)
                prev_host = odom[t + m - 1]
                t += m
                n -= m
            dispatch_fused(t, n)
            t = t + n + 1
        elif heavy_here and fuse_L > 0:
            # 0-light heavy rides the SAME fused program (n=0): only one
            # program per stage combo ever compiles on the fused path
            dispatch_fused(t, 0)
            t += 1
        elif heavy_here:
            step = heavy_factory(
                bool(do_refine), bool(do_update), bool(in_boot)
            )
            state, (bp, ne, sc) = step(
                state, jnp.asarray(odom[t]), jnp.asarray(ranges[t])
            )
            bps.append(bp[None] if bp.ndim == 1 else bp)
            nes.append(ne[None])
            scs.append(sc[None])
            emit_frame_maybe(bps[-1])
            prev_host = odom[t]
            t += 1
        else:
            n = 1
            while (
                n < LIGHT_SEG and t + n < T and not flags[t + n].any()
            ):
                n += 1
            dispatch_light(t, n)
            prev_host = odom[t + n - 1]
            t += n

    if frame_cb is not None and frame_buf:   # flush the tail frame
        best_map = jnp.take(state.logodds, jnp.argmax(state.log_w), axis=0)
        frame_cb(best_map, np.concatenate(frame_buf))
        frame_buf.clear()

    bps, nes, scs = jax.device_get((bps, nes, scs))
    return (
        state,
        np.concatenate([np.atleast_2d(b) for b in bps])[:T],
        np.concatenate([np.atleast_1d(n) for n in nes])[:T],
        np.concatenate([np.atleast_1d(s) for s in scs])[:T],
    )


def run_fastslam(
    log: dict,
    cfg: FrontendConfig,
    pf: PFConfig,
    seed: int = 0,
    state: PFState | None = None,
    frame_cb=None,
    host_gated: bool | None = None,
):
    """Returns (final_state, best_traj [T, 3], n_eff [T], best_scores [T]).

    `frame_cb(logodds, traj_chunk)` captures the BEST particle's map at
    each chunk boundary for animation export (fetches one [H, W] map per
    chunk — leave None on throughput runs).

    `host_gated` selects the stage-specialized dispatch strategy — see
    the module docstring; False keeps the single-program lax.cond form.
    Default (None): host-gated iff n_particles >=
    pf.host_gate_min_particles — the per-scan dispatch cost only
    amortizes when per-scan device work is larger."""
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk

    if state is None:
        state = fastslam_init(
            cfg, pf, jax.random.PRNGKey(seed), start_pose=odom[0]
        )
        state = state._replace(prev_odom=jnp.asarray(odom[0]))
    if host_gated is None:
        host_gated = pf.n_particles >= pf.host_gate_min_particles
    if host_gated:
        return _run_fastslam_host_gated(
            odom, ranges, cfg, pf, state, frame_cb
        )
    chunk_fn = make_pf_chunk_fn(cfg, pf)

    trajs, neffs, scores = [], [], []
    for s in range(0, T, K):
        o = odom[s : s + K]
        r = ranges[s : s + K]
        n_here = len(o)
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])
        state, (bp, ne, sc) = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        # outputs stay on device; one device_get at the end (see
        # run/frontend.py — per-chunk fetches serialize on transfer latency)
        trajs.append(bp)
        neffs.append(ne)
        scores.append(sc)
        if frame_cb is not None:
            best_map = jnp.take(
                state.logodds, jnp.argmax(state.log_w), axis=0
            )
            frame_cb(best_map, np.asarray(bp)[:n_here])

    trajs, neffs, scores = jax.device_get((trajs, neffs, scores))
    return (
        state,
        np.concatenate(trajs)[:T],
        np.concatenate(neffs)[:T],
        np.concatenate(scores)[:T],
    )
