"""Scan-matching SLAM frontend driver (SURVEY.md §5.1, configs 1-2).

The reference's `main.py` loop is: prior = prev ⊕ odom-delta; matchScan;
update grid; plot. Here the per-scan step is a pure jitted function, the
driver rolls `chunk` scans into one `lax.scan` (host only streams chunks and
collects trajectories — SURVEY.md §9 "host owns only streaming/control
flow"), and the map state is donated so the [H, W] grid never round-trips.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import FrontendConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import make_grid, integrate_scan, world_to_cell
from slam2d_tpu.grid.window import (
    blur_halo_cells,
    extract_window,
    scan_window_cells,
    update_window_cells,
    write_window,
    write_window_blur_exact,
)
from slam2d_tpu.match.correlative import build_search_space, match_scan


class FrontendState(NamedTuple):
    logodds: jax.Array       # [H, W]
    search_space: jax.Array  # [H, W] cached blurred likelihood field
    pose: jax.Array          # [3] current corrected pose estimate
    prev_odom: jax.Array     # [3] odometry pose at the previous scan
    dist: jax.Array          # scalar: cumulative distance traveled
    last_map_pose: jax.Array # [3] pose at the last map integration
    since_match: jax.Array   # [2] (translation, rotation) since last match


def frontend_init(cfg: FrontendConfig, start_pose=None, start_odom=None):
    pose = jnp.zeros(3, jnp.float32) if start_pose is None else jnp.asarray(start_pose, jnp.float32)
    odom = pose if start_odom is None else jnp.asarray(start_odom, jnp.float32)
    grid = make_grid(cfg.grid)
    # distinct buffers everywhere — the chunk runner donates the state, and
    # aliased leaves would be donated twice
    return FrontendState(
        grid,
        build_search_space(grid, cfg.matcher, cfg.grid.resolution),
        pose, odom + 0.0, jnp.float32(0.0), pose + 0.0,
        jnp.zeros(2, jnp.float32),
    )


def frontend_step(state: FrontendState, odom, ranges, cfg: FrontendConfig):
    """One scan: odometry prior -> gated correlative match -> gated map update.

    Bootstrap (first `bootstrap_dist` meters) trusts the odometry prior and
    integrates every scan. Afterwards the matcher runs only after enough
    motion since the last match (dead-reckoning in between) and the map only
    integrates on sufficient motion (see FrontendConfig for why both gates).

    Both heavy stages sit behind `lax.cond`, so gated-off scans cost almost
    nothing, and the blurred search space is CACHED in the state — it only
    changes when the map does, so it is rebuilt inside the update branch
    rather than per scan (the map blur was the per-scan bandwidth hot spot).
    """
    delta = se2.between(state.prev_odom, odom)
    step_len = jnp.hypot(delta[0], delta[1])
    prior = se2.compose(state.pose, delta)
    # localization mode: the map is given, so there is no bootstrap phase
    in_boot = (
        jnp.bool_(False) if cfg.localize_only
        else state.dist < cfg.bootstrap_dist
    )
    since_m = state.since_match + jnp.stack(
        [step_len, jnp.abs(se2.wrap_angle(delta[2]))]
    )
    do_match = (~in_boot) & (
        (since_m[0] >= cfg.match_min_motion) | (since_m[1] >= cfg.match_min_rot)
    )

    win = scan_window_cells(cfg.grid, cfg.sensor, cfg.matcher)
    windowed = win < min(cfg.grid.height, cfg.grid.width)
    # The update touches only max_range (+ blur halo for the cached-field
    # rebuild), not the match's translation-search margin — a smaller
    # window cuts the scatter/blur cost (both scale with window area).
    uwin = update_window_cells(cfg.grid, cfg.sensor, cfg.matcher)
    uwindowed = uwin < min(cfg.grid.height, cfg.grid.width)

    def match_branch(_):
        if not windowed:
            return match_scan(
                state.logodds, ranges, prior, cfg.grid, cfg.matcher,
                cfg.sensor, search_space=state.search_space,
            )
        center = world_to_cell(prior[:2], cfg.grid)
        Sw, (r0, c0) = extract_window(state.search_space, center, win)
        origin = (
            cfg.grid.origin_x + c0.astype(jnp.float32) * cfg.grid.resolution,
            cfg.grid.origin_y + r0.astype(jnp.float32) * cfg.grid.resolution,
        )
        return match_scan(
            state.logodds, ranges, prior, cfg.grid, cfg.matcher, cfg.sensor,
            search_space=Sw, origin_xy=origin,
        )

    def skip_match(_):
        return prior, jnp.float32(-1.0)

    pose, score = jax.lax.cond(do_match, match_branch, skip_match, None)
    since_m = jnp.where(do_match, jnp.zeros_like(since_m), since_m)

    if cfg.localize_only:
        # fixed map: no integration, no field rebuild — the whole update
        # stage is cut out of the trace
        dist = state.dist + step_len
        return (
            FrontendState(
                state.logodds, state.search_space, pose, odom, dist,
                state.last_map_pose, since_m,
            ),
            (pose, score),
        )

    moved = jnp.hypot(
        pose[0] - state.last_map_pose[0], pose[1] - state.last_map_pose[1]
    )
    rotated = jnp.abs(se2.wrap_angle(pose[2] - state.last_map_pose[2]))
    do_update = in_boot | (moved >= cfg.map_update_min_motion) | (
        rotated >= cfg.map_update_min_rot
    )

    # NOTE (round 5): a "window-joined" cond variant — branches return
    # only the [uwin, uwin] windows, with unconditional windowed writes —
    # was built, verified bit-identical on a full CPU run, and measured
    # slower on the previous accelerator: XLA handled this cond's
    # identity path efficiently, while the variant paid an unconditional
    # unaligned dynamic_slice + dynamic_update_slice per scan. Keep the
    # full-array cond (ROADMAP A3 re-measures on the GPU).
    def update_branch(_):
        if not uwindowed:
            logodds = integrate_scan(
                state.logodds, pose, ranges, cfg.grid, cfg.sensor
            )
            return logodds, build_search_space(
                logodds, cfg.matcher, cfg.grid.resolution
            )
        center = world_to_cell(pose[:2], cfg.grid)
        gw, (r0, c0) = extract_window(state.logodds, center, uwin)
        gw = integrate_scan(
            gw, pose, ranges, cfg.grid, cfg.sensor, origin_rc=(r0, c0)
        )
        logodds = write_window(state.logodds, gw, (r0, c0))
        # Recompute the blurred field on the window; the outer blur-halo
        # ring saw a truncated neighborhood so it is trimmed — EXCEPT on
        # sides where the window clamps against the grid border, where the
        # truncation matches reality (see write_window_blur_exact).
        Sw = build_search_space(gw, cfg.matcher, cfg.grid.resolution)
        halo = blur_halo_cells(cfg.matcher, cfg.grid.resolution)
        search_space = write_window_blur_exact(
            state.search_space, Sw, (r0, c0), halo
        )
        return logodds, search_space

    def skip_update(_):
        return state.logodds, state.search_space

    logodds, search_space = jax.lax.cond(
        do_update, update_branch, skip_update, None
    )
    last_map_pose = jnp.where(do_update, pose, state.last_map_pose)
    dist = state.dist + step_len
    return (
        FrontendState(
            logodds, search_space, pose, odom, dist, last_map_pose, since_m
        ),
        (pose, score),
    )


@functools.cache
def make_chunk_fn(cfg: FrontendConfig):
    """Jitted (state, odom_chunk [K,3], ranges_chunk [K,B]) -> (state, traj, scores)."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def chunk_fn(state, odom_chunk, ranges_chunk):
        def body(s, inp):
            o, r = inp
            s2, out = frontend_step(s, o, r, cfg)
            return s2, out

        state, (traj, scores) = jax.lax.scan(
            body, state, (odom_chunk, ranges_chunk), unroll=cfg.scan_unroll
        )
        return state, traj, scores

    return chunk_fn


@functools.cache
def make_multichunk_fn(cfg: FrontendConfig):
    """Jitted (state, odom [M,K,3], ranges [M,K,B]) -> (state, traj
    [M,K,3], scores [M,K]): one dispatch covering M chunks via an outer
    lax.scan over inner K-trip scans. Bit-identical to M chunk_fn
    dispatches; see FrontendConfig.chunks_per_dispatch for the measured
    motivation (per-dispatch overhead amortizes while the inner trip
    count stays at the sweet spot — flat longer scans ran slower per
    iteration)."""

    @functools.partial(jax.jit, donate_argnums=(0,))
    def fn(state, odom_mk, ranges_mk):
        def inner(s, inp):
            o, r = inp
            s2, out = frontend_step(s, o, r, cfg)
            return s2, out

        def outer(s, inp):
            o_k, r_k = inp
            s2, (traj, sc) = jax.lax.scan(
                inner, s, (o_k, r_k), unroll=cfg.scan_unroll
            )
            return s2, (traj, sc)

        state, (traj, scores) = jax.lax.scan(outer, state,
                                             (odom_mk, ranges_mk))
        return state, traj, scores

    return fn


def make_offline_fn(cfg: FrontendConfig):
    """Jitted whole-log program: (state, odom [T,3], ranges [T,B]) ->
    (state, traj [T,3], scores [T]) in ONE dispatch (T must be a
    multiple of cfg.chunk; run_frontend_offline pads for you).

    When the whole log is available up front (offline mapping — the
    reference's own batch usage), the chunk loop itself belongs ON
    DEVICE: one dispatch, one trajectory fetch. The program is the
    nested scan-of-scans (outer over T/chunk groups, inner over chunk
    scans), sharing the multichunk dispatch machinery. NOTE the
    measured caveat (round-5 dispatch decomposition, docs/
    COMPONENTS.md): per-scan device cost grows with the TOTAL scans
    one program covers — nesting at 128-scan span beats flat (M=2 >
    chunk-128 > chunk-64 streaming), but by kilo-scan span the
    penalty dominates either way (~30%+ over streaming), so this mode
    trades throughput for single-dispatch semantics. Use the
    streaming driver for throughput and online/incremental feeds."""

    mfn = make_multichunk_fn(cfg)

    def offline_fn(state, odom, ranges):
        T, B = ranges.shape
        K = cfg.chunk
        assert T % K == 0, (T, K)
        state, traj, scores = mfn(
            state, odom.reshape(T // K, K, 3), ranges.reshape(T // K, K, B)
        )
        return state, traj.reshape(T, 3), scores.reshape(T)

    return offline_fn


def run_frontend_offline(
    log: dict, cfg: FrontendConfig, state: FrontendState | None = None
):
    """Whole-log frontend in a single device dispatch (offline mapping).

    Same semantics as `run_frontend` (bit-identical map and trajectory —
    the chunk boundaries never carried state), minus the per-chunk
    dispatch overhead. Pads the tail to a chunk multiple exactly like
    the streaming driver (repeat the last record) and truncates the
    outputs. Returns (final_state, traj, scores)."""
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    if T % K:
        pad = K - T % K
        odom = np.concatenate([odom, np.repeat(odom[-1:], pad, axis=0)])
        ranges = np.concatenate(
            [ranges, np.repeat(ranges[-1:], pad, axis=0)]
        )
    if state is None:
        state = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])
    state, traj, scores = make_offline_fn(cfg)(
        state, jnp.asarray(odom), jnp.asarray(ranges)
    )
    traj, scores = jax.device_get((traj, scores))
    return state, traj[:T], scores[:T]


def _chunk_iter(odom: np.ndarray, ranges: np.ndarray, K: int):
    """Yield (o [K,3], r [K,B], n_here) with the tail chunk padded by
    repeating the last record (identical repeated odometry is a no-op
    motion; re-integrating the same scan at the same pose is harmless)."""
    T = len(odom)
    for s in range(0, T, K):
        o = odom[s : s + K]
        r = ranges[s : s + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])
        yield o, r, min(K, T - s)


def run_frontend(
    log: dict,
    cfg: FrontendConfig,
    state: FrontendState | None = None,
    frame_cb=None,
):
    """Run the full frontend over a host-side log dict {odom, ranges}.

    Pads the tail chunk by repeating the last record (repeated identical
    odometry is a no-op motion, and re-integrating the same scan at the same
    pose is harmless), then truncates the outputs.

    `frame_cb(logodds, traj_chunk)` is called at every chunk boundary for
    animation capture (viz.video.VideoRecorder.add) — it fetches the map
    per chunk, so leave it None on throughput runs.

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray).
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk

    if state is None:
        state = frontend_init(cfg, start_pose=odom[0], start_odom=odom[0])
    chunk_fn = make_chunk_fn(cfg)
    # group M chunks per dispatch where the log allows (bit-identical;
    # see FrontendConfig.chunks_per_dispatch) — the tail chunks that
    # don't fill a group go through the single-chunk program. Frame
    # capture keeps the documented per-CHUNK callback granularity, so
    # it disables grouping (viz runs are not throughput runs).
    M = (1 if frame_cb is not None
         else max(1, int(getattr(cfg, "chunks_per_dispatch", 1))))
    mfn = make_multichunk_fn(cfg) if M > 1 else None

    chunks = list(_chunk_iter(odom, ranges, K))
    trajs, scores = [], []
    i = 0
    while i < len(chunks):
        if M > 1 and i + M <= len(chunks):
            o = np.stack([chunks[i + j][0] for j in range(M)])
            r = np.stack([chunks[i + j][1] for j in range(M)])
            n_here = sum(chunks[i + j][2] for j in range(M))
            state, tr, sc = mfn(state, jnp.asarray(o), jnp.asarray(r))
            tr = tr.reshape(M * K, 3)
            sc = sc.reshape(M * K)
            i += M
        else:
            o, r, n_here = chunks[i]
            state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
            i += 1
        # keep outputs on device: a blocking fetch PER CHUNK serializes the
        # host loop on transfer latency;
        # one device_get at the end drains everything in a single round trip
        trajs.append(tr)
        scores.append(sc)
        if frame_cb is not None:
            frame_cb(state.logodds, np.asarray(tr)[:n_here])

    trajs, scores = jax.device_get((trajs, scores))
    traj = np.concatenate(trajs)[:T]
    score = np.concatenate(scores)[:T]
    return state, traj, score


def run_localization(
    log: dict,
    cfg: FrontendConfig,
    logodds,
    start_pose=None,
    recover: bool = False,
    recover_score: float = 0.25,
    recover_accept: float = 0.5,
    recover_margin: float = 0.0,
    recover_consistent: bool = True,
):
    """Pose tracking against a FIXED prebuilt map (no bootstrap, no map
    updates): the AMCL-style localization mode. `logodds` is any [H, W]
    log-odds map matching cfg.grid's geometry — e.g. a previous run's
    `map_logodds.npy`, or a ROS map_server pair via viz.ros_map.load_ros_map
    (pass its returned GridConfig as cfg.grid).

    With recover=True, a chunk whose matched scores collapse below
    `recover_score` (median; tracking lost — kidnapped robot, bad
    odometry splice) triggers whole-map FFT relocalization
    (match/global_loc.py) on the chunk's last scan. A candidate commits
    when it scores >= recover_accept, clears the peak-uniqueness margin
    `recover_margin` (0 disables — correct locks in self-similar worlds
    can have margins as low as ~0.01, overlapping aliased ones), and —
    with recover_consistent (default) — AGREES within ~1 m / 0.5 rad
    with the PREVIOUS chunk's candidate transported by the odometry
    between them. Perceptual aliasing (a look-alike room elsewhere)
    rarely survives that test: the impostor match shifts differently
    under the robot's real motion. One extra chunk of latency. Costs one score fetch per
    chunk (localization is interactive, not a throughput pipeline).

    Returns (final_state, traj [T, 3], scores [T], events) — events is a
    list of {"scan", "score", "margin", "pose"} dicts, one per accepted
    recovery (always [] when recover=False)."""
    import dataclasses

    cfg = dataclasses.replace(cfg, localize_only=True)
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    # copy: the chunk runner donates its input state, and jnp.asarray of a
    # float32 device array is a no-copy alias — donating THAT would delete
    # the caller's own map buffer
    grid = jnp.array(logodds, jnp.float32)
    assert grid.shape == (cfg.grid.height, cfg.grid.width), (
        grid.shape, (cfg.grid.height, cfg.grid.width))
    S = build_search_space(grid, cfg.matcher, cfg.grid.resolution)
    pose = jnp.asarray(
        odom[0] if start_pose is None else start_pose, jnp.float32
    )
    # built directly — frontend_init would blur a throwaway zero grid
    state = FrontendState(
        grid, S, pose, jnp.asarray(odom[0]) + 0.0, jnp.float32(0.0),
        pose + 0.0, jnp.zeros(2, jnp.float32),
    )
    if not recover:
        st, traj, score = run_frontend(log, cfg, state=state)
        return st, traj, score, []

    from slam2d_tpu.match.global_loc import global_localize
    from slam2d_tpu.run.frontend_tiled import _np_between, _np_compose

    chunk_fn = make_chunk_fn(cfg)
    events: list = []
    trajs, scores = [], []
    done = 0
    cand = None          # (pose_np, scan_index) from the previous trigger
    for o, r, n_here in _chunk_iter(odom, ranges, K):
        state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        trajs.append(tr)
        scores.append(sc)
        done += n_here
        sc_h = np.asarray(sc)[:n_here]
        # skipped (no-motion) scans return EXACTLY -1.0; genuinely matched
        # scans can score negative too (endpoints in known-free space),
        # and those are precisely the collapsed matches to detect
        matched = sc_h[sc_h != -1.0]
        if len(matched) >= 3 and float(np.median(matched)) < recover_score:
            last = done - 1
            # read the map/field from the LIVE state: chunk_fn donates its
            # input state, so the originals were deleted on the first call
            pose0, s0, m0 = global_localize(
                state.logodds, jnp.asarray(ranges[last]), cfg.grid,
                cfg.matcher, cfg.sensor, search_space=state.search_space,
                return_margin=True,
            )
            s0, m0 = float(s0), float(m0)
            pose0 = np.asarray(pose0, np.float32)
            gated = s0 >= recover_accept and m0 >= recover_margin
            agreed = not recover_consistent
            if gated and recover_consistent and cand is not None:
                # transport the previous candidate by the odometry
                # between the two trigger scans and compare
                dprev = _np_between(odom[cand[1]], odom[last])
                expect = _np_compose(cand[0], dprev)
                dd = _np_between(expect, pose0)
                agreed = (
                    float(np.hypot(dd[0], dd[1])) <= 1.0
                    and abs(float(dd[2])) <= 0.5
                )
            if gated and agreed:
                state = state._replace(pose=jnp.asarray(pose0))
                events.append({
                    "scan": last, "score": round(s0, 4),
                    "margin": round(m0, 4),
                    "pose": [round(float(v), 4) for v in pose0],
                })
                cand = None
            else:
                cand = (pose0, last) if gated else None
        else:
            # healthy chunk: expire any pending candidate so consistency
            # only ever compares CONSECUTIVE lost chunks — a stale
            # candidate transported through hundreds of scans (possibly
            # across a second kidnap's odometry lie) is meaningless
            cand = None
    trajs, scores = jax.device_get((trajs, scores))
    traj = np.concatenate(trajs)[:T]
    score = np.concatenate(scores)[:T]
    return state, traj, score, events
