"""Full SLAM: frontend + keyframes + loop closure + pose-graph backend
(SURVEY.md §5.3, config 5).

Host owns only control flow (keyframe admission, loop gating, when to
optimize); every dense computation is a jitted device call:

- frontend tracking: chunked `lax.scan` (run/frontend.py),
- loop candidate scoring: wide-window correlative match of the current
  keyframe scan against a submap rebuilt on device from the old keyframe's
  neighborhood,
- graph optimization: dense GN (graph/se2_graph.py),
- map rebuild after a correction: one `lax.scan` re-raycasting every
  keyframe scan at its corrected pose into a fresh grid.

Loop edges: z_ij = (Xi_est)^-1 ⊞ matched_Xj — the matched absolute pose of
keyframe j in the submap (built in world frame around keyframe i) composed
against i's estimate, exactly the relative-pose measurement GN expects.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import FrontendConfig, GraphConfig, MatcherConfig
from slam2d_tpu.core import se2
from slam2d_tpu.graph import se2_graph
from slam2d_tpu.grid.occupancy import make_grid, integrate_scan
from slam2d_tpu.match.correlative import (
    build_search_space,
    match_scan,
    peak_uniqueness,
)
from slam2d_tpu.run.frontend import frontend_init, make_chunk_fn

# Opt-in accept-path phase profiler (scripts/bench_accept_parts.py): a
# utils.profiling.PhaseTimer, or None (default — zero overhead, no extra
# syncs). When set, the accept path records per-phase host wall time WITH
# hard syncs at phase boundaries so device time is attributed to the phase
# that enqueued it; the syncs make the run slower than production, so only
# benches should install it.
ACCEPT_TIMER = None


def _accept_phase(name: str):
    import contextlib

    if ACCEPT_TIMER is None:
        return contextlib.nullcontext()
    return ACCEPT_TIMER.phase(name)


def _accept_sync(x):
    if ACCEPT_TIMER is not None:
        # a SCALAR fetch drains the dispatch queue, so queued work is
        # charged to the phase that enqueued it. Each phase still carries
        # one host round trip of inflation; read deltas, not absolutes.
        leaves = [l for l in jax.tree.leaves(x) if hasattr(l, "ravel")]
        if leaves:
            jax.device_get(leaves[0].ravel()[0])
from slam2d_tpu.run.frontend_tiled import (
    _np_between,
    _np_between_batch,
    _np_compose,
    _np_compose_batch,
    _np_inverse,
)


@functools.cache
def _make_rebuild_chunk(cfg: FrontendConfig, gcfg):
    from slam2d_tpu.grid.window import (
        extract_window,
        update_window_cells,
        write_window,
    )
    from slam2d_tpu.grid.occupancy import world_to_cell

    # each keyframe's scan only touches cells within max_range of its
    # pose — integrating into a static window instead of the full grid
    # cut the accept-path rebuild from 76 to ~20 ms/accept at 1024^2
    # (scripts/bench_accept_parts.py; update cost scales with the target
    # array, the same rule as pf/fastslam._windowed_update)
    uwin = update_window_cells(gcfg, cfg.sensor)
    windowed = uwin < min(gcfg.height, gcfg.width)

    @jax.jit
    def rebuild_chunk(grid, poses, scans, mask):
        def body(g, inp):
            p, r, m = inp
            if not windowed:
                return (
                    integrate_scan(g, p, r, gcfg, cfg.sensor, enable=m),
                    None,
                )
            center = world_to_cell(p[:2], gcfg)
            gw, orc = extract_window(g, center, uwin)
            gw = integrate_scan(
                gw, p, r, gcfg, cfg.sensor, enable=m, origin_rc=orc
            )
            return write_window(g, gw, orc), None

        grid, _ = jax.lax.scan(
            body, grid, (poses, scans, mask.astype(jnp.float32))
        )
        return grid

    return rebuild_chunk


def make_rebuild_fn(cfg: FrontendConfig, capacity: int, grid_cfg=None,
                    chunk: int = 32):
    """Re-raycast up to `capacity` keyframe scans into a fresh grid.

    The device work is a jitted CHUNK of `chunk` scans; the host loops
    only over chunks that contain active keyframes (n_active), so a
    7-keyframe submap costs one chunk instead of a `capacity`(=512)-step
    lax.scan — loop-closure scoring and post-loop rebuilds dominate the
    config-5 wall clock otherwise."""
    gcfg = grid_cfg or cfg.grid
    rebuild_chunk = _make_rebuild_chunk(cfg, gcfg)

    def rebuild(poses, scans, mask, n_active: int | None = None):
        n = capacity if n_active is None else min(int(n_active), capacity)
        n = ((max(n, 1) + chunk - 1) // chunk) * chunk
        n = min(n, capacity)
        grid = make_grid(gcfg)
        for s in range(0, n, chunk):
            grid = rebuild_chunk(
                grid, poses[s : s + chunk], scans[s : s + chunk],
                mask[s : s + chunk],
            )
        return grid

    return rebuild


def snap_render_poses(poses, n, map_poses, n_prev, eps_xy, eps_th):
    """Snap sub-eps pose corrections to the previously-RENDERED pose.

    Pose-graph corrections move EVERY keyframe by a float epsilon, but
    only poses that moved a meaningful fraction of a cell change the
    rendered map. Snapping lets the incremental rebuilders keep a long
    bit-exact prefix. Returns (snapped poses copy, k0) where k0 is the
    first keyframe index whose rendered pose changed (== n when nothing
    did). Mutates nothing; the graph/trajectory keep exact poses."""
    poses = np.array(poses, np.float32, copy=True)
    m = min(n, n_prev)
    if m == 0:
        return poses, 0
    d = np.hypot(
        poses[:m, 0] - map_poses[:m, 0], poses[:m, 1] - map_poses[:m, 1]
    )
    dth = (poses[:m, 2] - map_poses[:m, 2] + np.pi) % (2 * np.pi) - np.pi
    same = (d <= eps_xy) & (np.abs(dth) <= eps_th)
    poses[:m][same] = map_poses[:m][same]
    k0 = m if bool(same.all()) else int(np.argmax(~same))
    return poses, k0


class IncrementalRebuilder:
    """Post-loop map rebuild that re-raycasts only keyframes whose
    RENDERED pose moved (ROADMAP "map rebuild frequency").

    Gauss-Newton corrections leave a long prefix of early keyframes
    essentially fixed (node 0 is anchored; error spreads toward the
    loop), yet the naive rebuild re-raycasts all of them on every
    accepted loop — the dominating cost at MIT-Killian scale. This
    wrapper (a) snaps sub-quarter-cell corrections to the previously
    rendered pose, and (b) replays integration from a chunk-aligned
    cached prefix grid up to the first keyframe whose rendered pose
    changed. The result is bit-exact vs a from-scratch rebuild at the
    same snapped poses: the prefix replay is the identical integration
    sequence from the identical empty grid (log-odds clamping included).

    The snapped render poses are part of the resumable pipeline state
    (ckpt key "map_poses") so a split run reproduces the single run's
    maps; the prefix grid itself is NOT checkpointed — the first rebuild
    after a resume pays one full replay and re-primes the cache."""

    def __init__(self, cfg: FrontendConfig, capacity: int, grid_cfg=None,
                 chunk: int = 32, eps_cells: float = 0.25):
        gcfg = grid_cfg or cfg.grid
        self.gcfg = gcfg
        self.capacity = capacity
        self.chunk = chunk
        self.eps_xy = eps_cells * gcfg.resolution
        self.eps_th = eps_cells * gcfg.resolution / max(cfg.sensor.max_range, 1e-6)
        self._rebuild_chunk = _make_rebuild_chunk(cfg, gcfg)
        self.map_poses = np.zeros((capacity, 3), np.float32)
        self.n_prev = 0
        self.cache_grid = None
        self.cache_k = 0

    def restore(self, map_poses, n_prev: int):
        self.map_poses[: len(map_poses)] = np.asarray(map_poses, np.float32)
        self.n_prev = int(n_prev)
        self.cache_grid = None
        self.cache_k = 0

    def __call__(self, poses, scans, mask, n_active: int | None = None):
        n = self.capacity if n_active is None else min(int(n_active), self.capacity)
        n = max(n, 1)
        poses, k0 = snap_render_poses(
            np.asarray(poses), n, self.map_poses, self.n_prev,
            self.eps_xy, self.eps_th,
        )
        if self.cache_grid is not None and self.cache_k <= k0:
            grid, start = self.cache_grid, self.cache_k
        else:
            grid, start = make_grid(self.gcfg), 0
            self.cache_grid, self.cache_k = None, 0
        n_end = min(((n + self.chunk - 1) // self.chunk) * self.chunk,
                    self.capacity)
        poses_j = jnp.asarray(poses)
        for s in range(start, n_end, self.chunk):
            grid = self._rebuild_chunk(
                grid, poses_j[s : s + self.chunk], scans[s : s + self.chunk],
                mask[s : s + self.chunk],
            )
            # never cache the grid that will be RETURNED: it becomes the
            # frontend state and the next chunk_fn donates its buffer
            if s + self.chunk <= k0 and s + self.chunk < n_end:
                self.cache_grid, self.cache_k = grid, s + self.chunk
        self.map_poses[:n] = poses[:n]
        self.n_prev = n
        return grid


def default_submap_grid(cfg: FrontendConfig) -> "GridConfig":
    """Small zero-centered grid for keyframe-RELATIVE submaps: covers the
    sensor reach plus the loop search radius around the anchor keyframe."""
    import dataclasses
    import math

    half_m = cfg.sensor.max_range * 2.0 + 4.0
    size = int(math.ceil(2 * half_m / cfg.grid.resolution / 128)) * 128
    return dataclasses.replace(
        cfg.grid, height=size, width=size, center_x=0.0, center_y=0.0
    )


@functools.cache
def make_loop_attempt_fns(cfg: FrontendConfig, loop_matcher: MatcherConfig,
                          grid_cfg):
    """Fused loop-closure attempt + cached-submap rescoring.

    A loop attempt used to cost several host round trips (submap
    rebuild chunk, wide match, device_get) with max_nodes-padded
    host->device buffers, which halved config-5 throughput on
    revisit-heavy logs (scripts/bench_fullslam_parts.py). `attempt_full` re-raycasts the
    small keyframe neighborhood AND runs the wide-window match + peak
    diagnostic in ONE jitted call on tiny static buffers, returning the
    submap and its blurred field as device residents so the host can
    cache them; `attempt_cached` rescores a new scan against the cached
    pair in a single dispatch (no rebuild, no blur)."""
    gcfg = grid_cfg

    @jax.jit
    def attempt_full(poses, scans, mask, ranges, prior):
        def body(g, inp):
            p, r, m = inp
            return (
                integrate_scan(g, p, r, gcfg, cfg.sensor, enable=m),
                None,
            )

        grid, _ = jax.lax.scan(
            body, make_grid(gcfg), (poses, scans, mask.astype(jnp.float32))
        )
        S = build_search_space(grid, loop_matcher, gcfg.resolution)
        pose, score = match_scan(
            grid, ranges, prior, gcfg, loop_matcher, cfg.sensor,
            search_space=S,
        )
        margin = peak_uniqueness(
            grid, ranges, prior, gcfg, loop_matcher, cfg.sensor,
            search_space=S,
        )
        return grid, S, pose, score, margin

    @jax.jit
    def attempt_cached(grid, S, ranges, prior):
        pose, score = match_scan(
            grid, ranges, prior, gcfg, loop_matcher, cfg.sensor,
            search_space=S,
        )
        margin = peak_uniqueness(
            grid, ranges, prior, gcfg, loop_matcher, cfg.sensor,
            search_space=S,
        )
        return pose, score, margin

    return attempt_full, attempt_cached


class FullSLAMResult(NamedTuple):
    traj: np.ndarray          # [T, 3] per-scan trajectory (post-corrections)
    kf_poses: np.ndarray      # [K, 3] final keyframe poses
    kf_scan_idx: np.ndarray   # [K] scan index of each keyframe
    n_loops: int
    grid: jax.Array           # final [H, W] log-odds map
    chi2: float
    # accepted loop records: (i, j, score, zx, zy, ztheta) per loop
    loops: np.ndarray = np.zeros((0, 6), np.float32)
    # every ATTEMPTED loop closure:
    # (i, j, score, peak_margin, corr_xy, corr_theta, accepted,
    #  zx, zy, ztheta) — z* is the MEASURED relative pose i -> j, so an
    # offline sweep can label each attempt true/false against ground
    # truth and choose the accept gates from a precision/recall curve
    # (scripts/sweep_loop_gates.py)
    loop_attempts: np.ndarray = np.zeros((0, 10), np.float32)
    # resumable pipeline snapshot (see fullslam_ckpt_template) — save with
    # utils.checkpoint.save_state and pass back as `resume=`
    ckpt: dict | None = None


def fullslam_ckpt_template(cfg: FrontendConfig, graph_cfg: GraphConfig):
    """Empty checkpoint bundle (fixed shapes) — the checkpoint restore template
    and the schema `run_full_slam(..., resume=...)` expects. Everything the
    host loop owns lives here: frontend state, pose graph, the keyframe
    store (poses/scans/scan indices, padded to max_nodes), loop records,
    and the admission/cooldown counters (SURVEY.md §7 checkpoint/resume)."""
    Kmax = graph_cfg.max_nodes
    B = cfg.sensor.n_beams
    return {
        "frontend": frontend_init(cfg),
        "graph": se2_graph.graph_init(graph_cfg),
        "kf_poses": np.zeros((Kmax, 3), np.float32),
        "kf_scans": np.zeros((Kmax, B), np.float32),
        "kf_scan_idx": np.zeros(Kmax, np.int32),
        "kf_count": np.int32(0),
        "last_kf_pose": np.zeros(3, np.float32),
        "loops": np.zeros((graph_cfg.max_edges, 6), np.float32),
        "n_loops": np.int32(0),
        "chi2": np.float32(0.0),
        "cooldown": np.int32(0),
        # poses last used to RENDER the map (IncrementalRebuilder snaps
        # sub-quarter-cell corrections to these; checkpointed so a resumed
        # run reproduces the single run's maps bit-exactly)
        "map_poses": np.zeros((Kmax, 3), np.float32),
        "map_pose_count": np.int32(0),
        # anchor index of the host's submap cache (-1 = empty). The cached
        # submap itself is a pure function of keyframe state, so only the
        # anchor CHOICE must persist for a resumed run to replay the single
        # run's loop attempts exactly; the resumed run rebuilds it lazily.
        "loop_cache_anchor": np.int32(-1),
    }


def default_loop_matcher(graph_cfg: GraphConfig) -> MatcherConfig:
    return MatcherConfig(
        search_xy=graph_cfg.loop_radius / 2.0,
        search_theta=0.5,
        n_theta=41,
        coarse_factor=8,
        prior_xy_weight=0.0,       # loop search must not be pulled to the prior
        prior_theta_weight=0.0,
        min_score=0.0,
    )


def _retro_correct_traj(
    traj_out, kf_scan_idx, old_kf, corrected, upto_scan, offset=0
):
    """Apply pose-graph corrections to already-emitted per-scan poses:
    every scan between keyframe k and k+1 moves rigidly with keyframe k
    (left-multiplied by corrected_k ⊕ old_k^-1).

    `offset` maps stored (absolute) keyframe scan indices into this run's
    traj_out rows — on a resumed run, scans emitted by the previous run
    lie before row 0 and are clamped away (they were already written)."""
    nk = len(kf_scan_idx)
    for k in range(nk):
        lo = max(kf_scan_idx[k] - offset, 0)
        hi = (kf_scan_idx[k + 1] - offset) if k + 1 < nk else upto_scan + 1
        if lo >= hi:
            continue
        o = old_kf[k]
        c = corrected[k]
        co, so = np.cos(o[2]), np.sin(o[2])
        seg = traj_out[lo:hi].copy()
        # express each scan pose in old keyframe k's frame ...
        dx = seg[:, 0] - o[0]
        dy = seg[:, 1] - o[1]
        bx = co * dx + so * dy
        by = -so * dx + co * dy
        bth = seg[:, 2] - o[2]
        # ... and re-anchor it to the corrected keyframe
        cc, sc = np.cos(c[2]), np.sin(c[2])
        traj_out[lo:hi, 0] = c[0] + cc * bx - sc * by
        traj_out[lo:hi, 1] = c[1] + sc * bx + cc * by
        traj_out[lo:hi, 2] = (c[2] + bth + np.pi) % (2 * np.pi) - np.pi



class LoopCloser:
    """Shared loop-closure machinery for the full-SLAM drivers (bounded
    AND tiled): spatial anchor selection with a cached submap, fused
    attempt dispatch, batched ASYNC verdict resolution, acceptance gates,
    graph optimization, trajectory retro-correction, and frontend-pose
    transport. The driver supplies only `apply_correction(new_pose_np)`
    — the map rebuild + frontend-state patch, the one part that differs
    between the bounded and tiled pipelines.

    Attempts only ENQUEUE device work (`issue`): the match verdict is
    three scalars, and fetching them per attempt costs one blocking host
    round trip (the whole steady-state attempt cost). `resolve` drains
    every in-flight verdict in ONE device_get at the top of the next
    chunk iteration — the same inter-chunk point where a synchronous
    accept would have taken effect (state patches always land between
    chunks).

    Host-side accounting lives on the instance (n_loops, chi2,
    loop_records, attempt_records, cache_anchor, pending) so the driver
    reads it back when assembling the checkpoint. kf_poses / kf_scans /
    kf_scan_idx are the driver's LIVE lists, mutated in place on
    accepts."""

    def __init__(self, cfg, graph_cfg, loop_matcher, submap_cfg,
                 submap_halfwidth, graph, kf_poses, kf_scans, kf_scan_idx,
                 ranges_np, traj_out, optimizer, loop_edge_info,
                 scan_index_offset, apply_correction, loop_records,
                 n_loops=0, chi2=0.0, cache_anchor=-1, defer_accept=True):
        self.cfg = cfg
        self.gcfg = graph_cfg
        self.hw = submap_halfwidth
        self.graph = graph
        self.kf_poses = kf_poses
        self.kf_scans = kf_scans
        self.kf_scan_idx = kf_scan_idx
        self.ranges_np = ranges_np
        self.traj_out = traj_out
        self.optimizer = optimizer
        self.loop_edge_info = loop_edge_info
        self.scan_index_offset = scan_index_offset
        self.apply_correction = apply_correction
        self.loop_records = loop_records
        self.attempt_records: list = []
        self.n_loops = n_loops
        self.chi2 = chi2
        # submap cache: anchor keyframe index + device-resident
        # (grid, blurred field). Valid until the next ACCEPTED loop
        # (keyframe poses change) or until the robot leaves the anchor's
        # loop radius. The anchor index rides in the checkpoint
        # ("loop_cache_anchor"); the arrays are rebuilt lazily (a pure
        # function of keyframe state), so resumed runs replay identical
        # attempts.
        self.cache_anchor = cache_anchor
        self.cache_gs = None
        self.pending: list = []
        # Deferred accept (VERDICT r2 item 7): an accepted loop DISPATCHES
        # the GN solve and returns immediately; the poses+chi fetch and all
        # host bookkeeping (retro-correction, map rebuild, state patch)
        # happen at the NEXT chunk boundary, so the solve and its host
        # round trip overlap one chunk of tracking — the same latency
        # model as the async attempt verdicts. At most ONE accept is in
        # flight (the cooldown set at dispatch blocks further attempts).
        self.defer_accept = defer_accept
        self.pending_accept: dict | None = None
        # last ACCEPTED loop's newer keyframe — anchors the drift-relative
        # plausibility bound (path length since the estimate was last
        # pinned). -1 = no closure yet; resume restores it from the
        # loop records (n_loops > 0 implies records exist).
        self.last_accept_k = (
            max(int(r[1]) for r in loop_records) if loop_records else -1
        )
        # attempts requested while an accept is in flight: issuing them
        # against the pre-correction poses feeds the loop matcher a stale
        # prior (measured on the loop-dense parity log: a ~1 m-stale prior
        # let a 90-degree perceptual alias through the gates, ATE 0.10 ->
        # 0.52). They queue here and re-issue right after the finalize,
        # with corrected poses — sync semantics, one chunk later.
        self.deferred_issues: list = []
        self.attempt_full, self.attempt_cached = make_loop_attempt_fns(
            cfg, loop_matcher, submap_cfg
        )

    def find_loop(self, k_new: int):
        """Spatial gate: nearest old keyframe within loop_radius, index
        gap >= loop_min_gap. Returns candidate index or None."""
        if k_new < self.gcfg.loop_min_gap:
            return None
        p = self.kf_poses[k_new]
        old = np.stack(self.kf_poses[: k_new - self.gcfg.loop_min_gap + 1])
        d = np.hypot(old[:, 0] - p[0], old[:, 1] - p[1])
        i = int(np.argmin(d))
        return i if d[i] <= self.gcfg.loop_radius else None

    def issue(self, k_new: int, scan_i: int):
        """Dispatch a loop-closure attempt WITHOUT waiting for its result.

        Prefers the cached anchor while the new keyframe stays inside its
        loop radius (and keeps the index gap): consecutive attempts along
        a revisited stretch then skip the submap rebuild entirely."""
        if self.pending_accept is not None:
            # an accept is in flight: the prior would be stale (class
            # docstring) — queue; resolve re-issues after the finalize
            self.deferred_issues.append((k_new, scan_i))
            return
        i = None
        if (
            self.cache_anchor >= 0
            and k_new - self.cache_anchor >= self.gcfg.loop_min_gap
        ):
            a = self.kf_poses[self.cache_anchor]
            p = self.kf_poses[k_new]
            if np.hypot(a[0] - p[0], a[1] - p[1]) <= self.gcfg.loop_radius:
                i = self.cache_anchor
        if i is None:
            i = self.find_loop(k_new)
            self.cache_anchor = i if i is not None else -1
            self.cache_gs = None
        if i is None:
            return
        anchor = self.kf_poses[i]
        prior_rel = _np_between(anchor, self.kf_poses[k_new])
        if self.cache_gs is None:
            # submap from keyframe i's neighborhood, built in KEYFRAME
            # i's frame (poses relative to i, grid centered at 0): the
            # matched pose of the current scan in that frame IS the
            # measurement z_ij. Buffers are the small submap capacity,
            # not max_nodes — padded transfers and wasted scan steps
            # dominated the attempt cost (see make_loop_attempt_fns).
            lo = max(0, i - self.hw)
            hi = min(len(self.kf_poses), i + self.hw + 1)
            cap = 2 * self.hw + 2
            rel = _np_between_batch(anchor, np.stack(self.kf_poses[lo:hi]))
            poses_buf = np.zeros((cap, 3), np.float32)
            scans_buf = np.zeros((cap, self.ranges_np.shape[1]), np.float32)
            mask_buf = np.zeros(cap, np.float32)
            nsub = hi - lo
            poses_buf[:nsub] = rel
            scans_buf[:nsub] = np.stack(self.kf_scans[lo:hi])
            mask_buf[:nsub] = 1.0
            g_d, S_d, pose_d, score_d, margin_d = self.attempt_full(
                jnp.asarray(poses_buf), jnp.asarray(scans_buf),
                jnp.asarray(mask_buf), jnp.asarray(self.ranges_np[scan_i]),
                jnp.asarray(prior_rel),
            )
            self.cache_gs = (g_d, S_d)
        else:
            pose_d, score_d, margin_d = self.attempt_cached(
                self.cache_gs[0], self.cache_gs[1],
                jnp.asarray(self.ranges_np[scan_i]), jnp.asarray(prior_rel),
            )
        self.pending.append({
            "i": i, "k_new": k_new, "scan_i": scan_i,
            "prior_rel": np.asarray(prior_rel),
            "outs": (pose_d, score_d, margin_d),
        })

    def resolve(self, est, emitted_upto):
        """Drain every in-flight attempt in ONE device_get and apply the
        gates; the first accept wins, later in-flight attempts inside its
        cooldown horizon drop (the synchronous formulation's cooldown
        would have blocked them) and ones beyond it are re-issued against
        the corrected state.

        Returns (cooldown | None, est, last_kf_pose | None, T_acc | None):
        the driver adopts a non-None cooldown / admission reference,
        always the returned est (unchanged when nothing was accepted),
        and left-applies T_acc — the composed correction transform of
        every accept in this drain — to any chunk outputs it dispatched
        BEFORE this resolve but has not yet processed (the software-
        pipelined fetch, see run_full_slam's loop)."""
        new_last_kf = None
        T_acc = None
        deferred_issues: list = []
        if self.pending_accept is not None:
            # finalize the accept dispatched at the PREVIOUS boundary:
            # the GN solve + fetch overlapped the last chunk's tracking
            est, new_last_kf, T_acc = self._finalize_accept(
                est, emitted_upto
            )
            deferred_issues = self.deferred_issues
            self.deferred_issues = []
        if not self.pending:
            for k, s in deferred_issues:
                self.issue(k, s)
            return None, est, new_last_kf, T_acc
        outs = jax.device_get([a["outs"] for a in self.pending])
        batch = [(a, o) for a, o in zip(list(self.pending), outs)]
        self.pending.clear()
        accepted_k = None
        new_cooldown = None
        reissue = []
        for a, (matched_rel, score, margin) in batch:
            if accepted_k is not None:
                if a["k_new"] - accepted_k > self.gcfg.loop_cooldown:
                    reissue.append(a)
                continue
            # correction implied on the estimate (the plausibility gate)
            corr = _np_between(a["prior_rel"], matched_rel)
            attempt = [float(a["i"]), float(a["k_new"]), float(score),
                       float(margin), float(np.hypot(corr[0], corr[1])),
                       float(abs(corr[2])), 0.0,
                       float(matched_rel[0]), float(matched_rel[1]),
                       float(matched_rel[2])]
            self.attempt_records.append(attempt)
            if float(score) < self.gcfg.loop_score_accept:
                continue
            if float(margin) < self.gcfg.loop_min_peak_margin:
                continue
            # drift-relative plausibility bound: a true closure's
            # correction scales with the drift accumulated along the path
            # since the estimate was last pinned (the later of the matched
            # keyframe and the last accepted closure) — keyframe arc
            # length is the proxy (ADVICE r4: fixed bounds silently
            # reject long-drift true loops on endurance-length logs)
            lo = max(int(a["i"]), self.last_accept_k)
            travel = 0.0
            if 0 <= lo < a["k_new"]:
                seg = np.stack(self.kf_poses[lo: a["k_new"] + 1])
                travel = float(
                    np.sum(np.hypot(np.diff(seg[:, 0]), np.diff(seg[:, 1])))
                )
            max_xy = max(
                self.gcfg.loop_max_correction_xy,
                self.gcfg.loop_correction_drift_xy * travel,
            )
            max_th = max(
                self.gcfg.loop_max_correction_theta,
                self.gcfg.loop_correction_drift_theta * travel,
            )
            if (
                np.hypot(corr[0], corr[1]) > max_xy
                or abs(corr[2]) > max_th
            ):
                continue
            attempt[6] = 1.0
            if self.defer_accept:
                # dispatch only; bookkeeping lands at the next resolve
                self._accept_dispatch(
                    a["i"], a["k_new"],
                    np.asarray(matched_rel, np.float32), float(score),
                )
            else:
                est, nl_sync, Tc = self._accept(
                    a["i"], a["k_new"],
                    np.asarray(matched_rel, np.float32), float(score),
                    est, emitted_upto,
                )
                new_last_kf = nl_sync
                T_acc = Tc if T_acc is None else np.asarray(
                    _np_compose(Tc, T_acc), np.float32
                )
            accepted_k = a["k_new"]
            self.last_accept_k = a["k_new"]
            # sync-equivalent cooldown: keyframes admitted since the
            # accepted one already consumed part of it
            new_cooldown = max(
                0,
                self.gcfg.loop_cooldown
                - (len(self.kf_poses) - 1 - a["k_new"]),
            )
        for a in reissue:
            self.issue(a["k_new"], a["scan_i"])
        # deferred issues re-issue UNFILTERED in both resolve paths (here
        # and the empty-pending early return above): the driver-side
        # cooldown — adopted at accept DISPATCH time — is the actual gate,
        # so anything that reached deferred_issues was already outside the
        # accepted keyframe's cooldown horizon. (A cooldown filter here
        # was dead code: deferred_issues is non-empty only after a
        # finalize, and at a finalize `pending` is always empty — issue()
        # queues while the accept is in flight — so this branch never ran
        # with deferred issues; ADVICE r3.)
        for k, s in deferred_issues:
            self.issue(k, s)
        return new_cooldown, est, new_last_kf, T_acc

    def _dispatch_optimize(self, i, k_new, z, score):
        """Add the loop edge, transfer the graph, and ENQUEUE the GN solve.
        Returns device handles (poses[:n_now], chi) — not fetched."""
        gcfg = self.gcfg
        self.graph.add_edge(i, k_new, z, np.eye(3) * self.loop_edge_info)
        self.loop_records.append((i, k_new, score, z[0], z[1], z[2]))
        self.n_loops += 1
        with _accept_phase("accept/graph_to_device"):
            dev_graph = self.graph.to_device()
            _accept_sync(dev_graph)
        optimizer = self.optimizer
        if optimizer == "auto":
            # dense f32 Cholesky is exact to ~1k keyframes but NaNs from
            # the chain's f32 conditioning collapse by ~2k; the
            # hierarchical solver converges at every K
            optimizer = "dense" if len(self.kf_poses) <= 1024 else "hier"
        if optimizer == "schur":
            from slam2d_tpu.graph.schur import optimize_schur

            dev_graph, chi = optimize_schur(dev_graph, gcfg, n_blocks=4)
        elif optimizer == "schur_sharded":
            from slam2d_tpu.graph.schur import optimize_schur_sharded
            from slam2d_tpu.parallel.mesh import make_particle_mesh

            mesh = make_particle_mesh()
            dev_graph, chi = optimize_schur_sharded(dev_graph, gcfg, mesh)
        elif optimizer == "sparse":
            from slam2d_tpu.graph.sparse import optimize_cg

            dev_graph, chi = optimize_cg(dev_graph, gcfg)
        elif optimizer == "hier":
            from slam2d_tpu.graph.sparse import optimize_hier

            dev_graph, chi = optimize_hier(dev_graph, gcfg)
        else:
            dev_graph, chi = se2_graph.optimize(dev_graph, gcfg)
        # Post-solve chi^2 loop-edge pruning (round-5 endurance
        # diagnosis): 2 corridor-aliased closures passed every accept
        # gate (scores 0.68/0.79, margins above threshold) and DCS only
        # attenuated them — at the converged solution their whitened
        # residual^2 was ~14 vs ~0.014 for true edges (1000x separation),
        # so a single chi gate removes them cleanly. Masked re-solve from
        # the solved iterate; accepts are rare, the extra solve is noise
        # next to the accept's ~160 ms. Pruned flags ride the same fetch
        # and disable the HostGraph edges permanently.
        prune_chi2 = float(getattr(gcfg, "loop_prune_chi2", 0.0))

        def prune_mask(solved_graph, chi):
            # Two detectors (round-5 endurance diagnosis):
            # 1. absolute per-edge whitened residual^2 > threshold — the
            #    stiff-graph case where an alias visibly fights.
            # 2. converged-chi DELTA of THIS accept > threshold — the
            #    insidious case: the measured corridor aliases bent the
            #    whole graph to chi-consistency (their own residual^2
            #    converged to ~0.5) but raised the converged TOTAL by
            #    ~14 each, where true accepts add ~0.15 (90x
            #    separation). chi_prev is the last solve's converged
            #    value (host float; rides the checkpoint).
            chis = se2_graph.edge_chi2s(solved_graph.poses, solved_graph)
            ei = solved_graph.edges_ij[:, 0]
            ej = solved_graph.edges_ij[:, 1]
            is_loop = (
                (ej != ei + 1) & (ei != ej + 1) & solved_graph.edge_mask
            )
            prune = is_loop & (chis > prune_chi2)
            delta_bad = (chi - jnp.float32(self.chi2)) > prune_chi2
            new_e = jnp.arange(chis.shape[0]) == (self.graph.n_edges - 1)
            return prune | (new_e & delta_bad)

        if prune_chi2 > 0.0 and optimizer in ("schur", "schur_sharded"):
            # the Schur optimizers do host-side plan building (numpy
            # slicing of edges_ij) and cannot trace under lax.cond;
            # prune flags still persist to the HostGraph, so the NEXT
            # optimize excludes the edges — the correction lands one
            # accept later
            prune = prune_mask(dev_graph, chi)
        elif prune_chi2 > 0.0:
            prune = prune_mask(dev_graph, chi)
            g_masked = dev_graph._replace(
                edge_mask=dev_graph.edge_mask & ~prune
            )
            # re-solve ONLY when something was pruned: with GNC/DCS a
            # warm-started re-solve is NOT a no-op (the annealing
            # restarts from the solved iterate), so an unconditional
            # re-solve perturbed every clean accept (measured round 5:
            # it changed the whole endurance accept sequence). lax.cond
            # keeps the decision on-device — no extra fetch.
            poses2, chi2_ = jax.lax.cond(
                jnp.any(prune),
                lambda: self._rerun_optimizer_poses(optimizer, g_masked),
                lambda: (dev_graph.poses, chi),
            )
            dev_graph = dev_graph._replace(poses=poses2)
            chi = chi2_
        else:
            prune = jnp.zeros(
                dev_graph.edge_mask.shape, dtype=bool
            )
        return dev_graph.poses[: len(self.kf_poses)], chi, prune

    def _rerun_optimizer_poses(self, optimizer, g):
        g2, chi = self._rerun_optimizer(optimizer, g)
        return g2.poses, chi

    def _rerun_optimizer(self, optimizer, g):
        gcfg = self.gcfg
        if optimizer == "schur":
            from slam2d_tpu.graph.schur import optimize_schur

            return optimize_schur(g, gcfg, n_blocks=4)
        if optimizer == "schur_sharded":
            from slam2d_tpu.graph.schur import optimize_schur_sharded
            from slam2d_tpu.parallel.mesh import make_particle_mesh

            return optimize_schur_sharded(g, gcfg, make_particle_mesh())
        if optimizer == "sparse":
            from slam2d_tpu.graph.sparse import optimize_cg

            return optimize_cg(g, gcfg)
        if optimizer == "hier":
            from slam2d_tpu.graph.sparse import optimize_hier

            return optimize_hier(g, gcfg)
        return se2_graph.optimize(g, gcfg)

    def _accept_dispatch(self, i, k_new, z, score):
        """Deferred-accept first half: enqueue the solve, remember enough
        to finish the bookkeeping at the next chunk boundary."""
        assert self.pending_accept is None
        dev = self._dispatch_optimize(i, k_new, z, score)
        self.pending_accept = {
            "n0": len(self.kf_poses),   # keyframes covered by the solve
            "dev": dev,
            # for the Schur host-persist prune path: if THIS edge was
            # delta-chi-rejected, the fetched poses carry its aliased
            # correction — fall back to no-op poses
            "new_edge_idx": self.graph.n_edges - 1,
        }

    def _apply_prune(self, pruned):
        """Persist post-solve chi^2 prunes: disable the flagged loop
        edges in the HostGraph so every future optimize excludes them."""
        idx = np.nonzero(np.asarray(pruned))[0]
        if len(idx):
            self.graph.edge_mask[idx] = False
            self.n_pruned = getattr(self, "n_pruned", 0) + len(idx)

    def _finalize_accept(self, est, emitted_upto):
        """Deferred-accept second half (one chunk after dispatch): fetch
        the corrected poses, transport keyframes admitted during the
        overlap rigidly with the last solved keyframe, and run the usual
        correction tail. Returns (est, last_kf_pose, Tc)."""
        pa = self.pending_accept
        self.pending_accept = None
        with _accept_phase("accept/optimize+fetch"):
            corrected0, chi_h, pruned = jax.device_get(pa["dev"])
        self._apply_prune(pruned)
        self.chi2 = float(chi_h)
        n0 = pa["n0"]
        nk = len(self.kf_poses)
        old_kf = np.stack(self.kf_poses)   # pre-correction for ALL k
        if np.asarray(pruned)[pa.get("new_edge_idx", -1)]:
            # the accept itself was delta-chi-rejected; for optimizers
            # whose prune lands host-side (no in-dispatch re-solve) the
            # fetched poses still carry the aliased correction — apply
            # nothing instead (the cond-path optimizers already
            # re-solved, where corrected0 ~= old poses anyway)
            corrected0 = old_kf[:n0].copy()
        # keyframes admitted while the solve was in flight move rigidly
        # with the last SOLVED keyframe (the same left transform the
        # frontend-pose patch uses)
        Tc = np.asarray(
            _np_compose(corrected0[n0 - 1], _np_inverse(old_kf[n0 - 1])),
            np.float32,
        )
        if nk > n0:
            corrected = np.concatenate(
                [corrected0[:n0], _np_compose_batch(Tc, old_kf[n0:])]
            ).astype(np.float32)
        else:
            corrected = np.asarray(corrected0[:n0], np.float32)
        return self._apply_corrected(
            corrected, old_kf, est, emitted_upto
        )

    def _accept(self, i, k_new, z, score, est, emitted_upto):
        # synchronous form (defer_accept=False): dispatch + fetch + tail
        new_edge_idx = self.graph.n_edges  # index add_edge will use
        dev = self._dispatch_optimize(i, k_new, z, score)
        with _accept_phase("accept/optimize+fetch"):
            # ONE blocking fetch for poses + chi (separate np.asarray/float
            # calls each cost a full host round trip)
            corrected, chi_h, pruned = jax.device_get(dev)
        self._apply_prune(pruned)
        self.chi2 = float(chi_h)
        old_kf = np.stack(self.kf_poses)
        if np.asarray(pruned)[new_edge_idx]:
            # delta-chi-rejected accept: apply no correction (see
            # _finalize_accept note)
            corrected = old_kf[: len(corrected)].copy()
        return self._apply_corrected(
            np.asarray(corrected, np.float32), old_kf, est, emitted_upto
        )

    def _apply_corrected(self, corrected, old_kf, est, emitted_upto):
        """Shared correction tail: graph/keyframe pose update, submap-cache
        invalidation, trajectory retro-correction, frontend transport, and
        the driver's map rebuild. Returns (est, last_kf_pose, Tc)."""
        self.graph.set_poses(corrected)
        for k in range(len(self.kf_poses)):
            self.kf_poses[k] = corrected[k]
        # keyframe poses changed: the cached submap is stale
        self.cache_anchor = -1
        self.cache_gs = None
        # correct every emitted row: scans between keyframe k and k+1
        # move rigidly with keyframe k (including rows written after the
        # attempt's scan — an async accept resolves >= one chunk later)
        with _accept_phase("accept/retro_correct_host"):
            _retro_correct_traj(
                self.traj_out, self.kf_scan_idx, old_kf, corrected,
                emitted_upto, offset=self.scan_index_offset,
            )
        # patch the live frontend pose: transport the motion since the
        # LAST keyframe (in its pre-correction frame) onto its corrected
        # pose. NOT the accepted keyframe k_new — by resolution time later
        # keyframes exist, and composing a k_new-relative delta onto
        # kf_poses[-1] would teleport the pose by their separation.
        # Expressed as a LEFT transform Tc = corrected_last ∘ old_last^-1
        # so the driver can apply it to the live DEVICE pose (which, with
        # the pipelined fetch, may already be a chunk ahead of `est`):
        # Tc ∘ est == corrected_last ∘ (old_last^-1 ∘ est), the original
        # keyframe-relative transport, by associativity.
        Tc = np.asarray(
            _np_compose(self.kf_poses[-1], _np_inverse(old_kf[-1])),
            np.float32,
        )
        est = np.asarray(_np_compose(Tc, est), np.float32)
        # driver-specific tail: map rebuild + frontend-state patch; the
        # admission-gate reference rides with the same correction
        with _accept_phase("accept/apply_correction"):
            self.apply_correction(Tc)
        return est, self.kf_poses[-1].copy(), Tc


def run_full_slam(
    log: dict,
    cfg: FrontendConfig,
    graph_cfg: GraphConfig,
    loop_matcher: MatcherConfig | None = None,
    submap_halfwidth: int = 3,
    odom_edge_info: float = 50.0,
    loop_edge_info: float = 200.0,
    optimizer: str = "auto",
    resume: dict | None = None,
    scan_index_offset: int = 0,
    incremental_rebuild: bool = True,
    frame_cb=None,
    defer_accept: bool = True,
):
    """Run config-5 SLAM over a host-side log. Returns FullSLAMResult.

    `frame_cb(logodds, traj_chunk)` captures the map at each chunk
    boundary for animation export (viz.video.VideoRecorder.add); the map
    fetch piggybacks on the chunk's existing trajectory drain.

    optimizer: "dense" (one Cholesky over all keyframes), "schur"
    (block-eliminated — the form that scales/distributes), or
    "schur_sharded" (block axis sharded over all visible devices;
    separator system psum-reduced).

    resume: a checkpoint bundle (FullSLAMResult.ckpt of a previous run,
    possibly round-tripped through utils.checkpoint) to continue from;
    pair with scan_index_offset = number of scans the previous run already
    consumed so keyframe scan indices stay absolute across the split."""
    loop_matcher = loop_matcher or default_loop_matcher(graph_cfg)

    odom_np = np.asarray(log["odom"], np.float32)
    ranges_np = np.asarray(log["ranges"], np.float32)
    T = len(odom_np)
    K = cfg.chunk

    chunk_fn = make_chunk_fn(cfg)
    rebuild = IncrementalRebuilder(
        cfg, graph_cfg.max_nodes,
        # eps 0 = nothing snaps, every rebuild replays from scratch (the
        # A/B baseline: the naive full re-raycast per accepted loop)
        eps_cells=0.25 if incremental_rebuild else 0.0,
    )
    # submaps are built in the ANCHOR KEYFRAME's frame on a small
    # zero-centered grid — independent of world extent, so the same jitted
    # functions serve bounded and tiled/unbounded worlds
    submap_cfg = default_submap_grid(cfg)
    attempt_full, attempt_cached = make_loop_attempt_fns(
        cfg, loop_matcher, submap_cfg
    )

    # host-side keyframe store (restored from `resume` when given)
    if resume is not None:
        state = jax.tree.map(jnp.asarray, resume["frontend"])
        graph = se2_graph.HostGraph.from_arrays(graph_cfg, resume["graph"])
        kc = int(resume["kf_count"])
        kf_poses = [np.asarray(resume["kf_poses"][k]) for k in range(kc)]
        kf_scans = [np.asarray(resume["kf_scans"][k]) for k in range(kc)]
        kf_scan_idx = [int(resume["kf_scan_idx"][k]) for k in range(kc)]
        nl = int(resume["n_loops"])
        loop_records = [tuple(np.asarray(resume["loops"][k])) for k in range(nl)]
        n_loops = nl
        chi2 = float(resume["chi2"])
        init_cooldown = int(resume["cooldown"])
        init_last_kf = (
            np.asarray(resume["last_kf_pose"]) if kc > 0 else None
        )
        if "map_poses" in resume:
            rebuild.restore(resume["map_poses"], resume["map_pose_count"])
        init_cache_anchor = (
            int(resume["loop_cache_anchor"])
            if "loop_cache_anchor" in resume else -1
        )
    else:
        state = frontend_init(cfg, start_pose=odom_np[0], start_odom=odom_np[0])
        graph = se2_graph.HostGraph(graph_cfg)
        kf_poses = []
        kf_scans = []
        kf_scan_idx = []
        loop_records = []
        n_loops = 0
        chi2 = 0.0
        init_cooldown = 0
        init_last_kf = None
        init_cache_anchor = -1
    traj_out = np.zeros((T, 3), np.float32)

    def admit_keyframe(pose, scan_i):
        # pure-host admission: an eager device graph update here costs
        # several remote dispatches PER KEYFRAME (see se2_graph.HostGraph)
        kf_poses.append(pose.copy())
        kf_scans.append(ranges_np[scan_i])
        kf_scan_idx.append(scan_i + scan_index_offset)  # absolute index
        graph.add_node(pose)
        k = len(kf_poses) - 1
        if k > 0:
            z = _np_between(kf_poses[k - 1], pose)
            graph.add_edge(k - 1, k, z, np.eye(3) * odom_edge_info)
        return k

    def apply_correction(corr_np):
        # rebuild the global map from all (corrected) keyframes and patch
        # the live frontend. `corr_np` is the LEFT correction transform
        # (LoopCloser._accept): applied to the device pose it stays valid
        # even when a pipelined chunk has advanced the pose past the est
        # the host resolved against.
        nonlocal state
        Tc = jnp.asarray(corr_np, jnp.float32)
        Kmax = graph_cfg.max_nodes
        poses_buf = np.zeros((Kmax, 3), np.float32)
        scans_buf = np.zeros((Kmax, ranges_np.shape[1]), np.float32)
        mask_buf = np.zeros(Kmax, np.float32)
        nk = len(kf_poses)
        poses_buf[:nk] = np.stack(kf_poses)
        scans_buf[:nk] = np.stack(kf_scans)
        mask_buf[:nk] = 1.0
        with _accept_phase("accept/rebuild_grid"):
            new_grid = rebuild(
                jnp.asarray(poses_buf), jnp.asarray(scans_buf),
                jnp.asarray(mask_buf), n_active=nk,
            )
            _accept_sync(new_grid)
        with _accept_phase("accept/search_space"):
            new_pose = se2.compose(Tc, state.pose)
            state = state._replace(
                logodds=new_grid,
                search_space=build_search_space(
                    new_grid, cfg.matcher, cfg.grid.resolution
                ),
                pose=new_pose,
                last_map_pose=new_pose + 0.0,
            )
            _accept_sync(state.search_space)

    closer = LoopCloser(
        cfg, graph_cfg, loop_matcher, submap_cfg, submap_halfwidth,
        graph, kf_poses, kf_scans, kf_scan_idx, ranges_np, traj_out,
        optimizer, loop_edge_info, scan_index_offset, apply_correction,
        loop_records, n_loops=n_loops, chi2=chi2,
        cache_anchor=init_cache_anchor, defer_accept=defer_accept,
    )

    # ---- main host loop over chunks (software-pipelined fetch) ------------
    # A blocking fetch costs a round trip largely independent of payload
    # size, so a BLOCKING per-chunk trajectory fetch caps no-loop
    # throughput (fetching "only an admit mask" would cost the same round
    # trip). Instead the loop dispatches chunk c, THEN drains chunk c-1's
    # outputs — the fetch overlaps chunk c's device execution, hiding the
    # round trip entirely when chunk compute is longer. Keyframe admission / attempt issuance therefore
    # run one chunk behind the device; loop-accept corrections patch the
    # in-flight state as a LEFT transform (see apply_correction) and the
    # same transform is left-applied to the not-yet-processed chunk's rows
    # (pend_T) so admissions always see corrected poses.
    emitted_upto = -1   # last traj_out row written (run-local index)
    last_kf_pose = init_last_kf
    cooldown = init_cooldown
    est = np.asarray(state.pose)
    pend = None          # dispatched-but-unprocessed chunk outputs
    pend_T = None        # left transform owed to pend's rows

    def process_pending():
        nonlocal pend, pend_T, est, emitted_upto, last_kf_pose, cooldown
        if pend is None:
            return
        tr, est_new = jax.device_get((pend["tr"], pend["pose"]))
        n_here = pend["n"]
        tr = np.asarray(tr)[:n_here]
        est = np.asarray(est_new, np.float32)
        if pend_T is not None:
            tr = _np_compose_batch(pend_T, tr)
            est = np.asarray(_np_compose(pend_T, est), np.float32)
            pend_T = None
        s0 = pend["s0"]
        traj_out[s0 : s0 + n_here] = tr
        emitted_upto = s0 + n_here - 1
        if frame_cb is not None:
            frame_cb(pend["logodds"], tr)

        # keyframe admission over this chunk
        for t in range(n_here):
            scan_i = s0 + t
            pose = tr[t]
            if last_kf_pose is None:
                last_kf_pose = pose
                admit_keyframe(pose, scan_i)
                continue
            moved = np.hypot(*(pose[:2] - last_kf_pose[:2]))
            rot = abs(
                (pose[2] - last_kf_pose[2] + np.pi) % (2 * np.pi) - np.pi
            )
            if moved >= graph_cfg.keyframe_dist or rot >= graph_cfg.keyframe_angle:
                if len(kf_poses) >= graph_cfg.max_nodes - 1:
                    continue
                last_kf_pose = pose
                k_new = admit_keyframe(pose, scan_i)
                if cooldown > 0:
                    cooldown -= 1
                else:
                    closer.issue(k_new, scan_i)
        pend = None

    for s0 in range(0, T, K):
        o = odom_np[s0 : s0 + K]
        r = ranges_np[s0 : s0 + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])
        state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        # capture BEFORE resolve: an accept patches `state`, and these
        # pre-patch device values then owe pend_T. The pose (and, for
        # animation capture, the map) must be COPIED: chunk_fn donates its
        # input state, so next iteration's dispatch deletes these buffers
        # before process_pending reads them.
        cand = {
            "s0": s0, "n": min(K, T - s0), "tr": tr,
            "pose": state.pose + 0.0,
            "logodds": (state.logodds + 0) if frame_cb is not None else None,
        }
        process_pending()
        cd, est, nl, T_acc = closer.resolve(est, emitted_upto)
        if cd is not None:
            cooldown = cd
        if nl is not None:
            last_kf_pose = nl
        if T_acc is not None:
            pend_T = T_acc if pend_T is None else np.asarray(
                _np_compose(T_acc, pend_T), np.float32
            )
        pend = cand

    process_pending()
    # drain fully: an accept can re-issue attempts, and a deferred accept
    # still needs its finalize pass
    while closer.pending or closer.pending_accept is not None:
        cd, est, nl, _ = closer.resolve(est, emitted_upto)
        if cd is not None:
            cooldown = cd
        if nl is not None:
            last_kf_pose = nl
    ckpt = fullslam_ckpt_template(cfg, graph_cfg)
    ckpt["frontend"] = state
    ckpt["graph"] = graph.to_device()
    nk = len(kf_poses)
    if nk:
        ckpt["kf_poses"][:nk] = np.stack(kf_poses)
        ckpt["kf_scans"][:nk] = np.stack(kf_scans)
        ckpt["kf_scan_idx"][:nk] = np.asarray(kf_scan_idx, np.int32)
        ckpt["last_kf_pose"] = np.asarray(
            last_kf_pose if last_kf_pose is not None else kf_poses[-1],
            np.float32,
        )
    ckpt["kf_count"] = np.int32(nk)
    if loop_records:
        ckpt["loops"][:closer.n_loops] = np.asarray(loop_records, np.float32)
    ckpt["n_loops"] = np.int32(closer.n_loops)
    ckpt["chi2"] = np.float32(closer.chi2)
    ckpt["cooldown"] = np.int32(cooldown)
    ckpt["loop_cache_anchor"] = np.int32(closer.cache_anchor)
    ckpt["map_poses"] = rebuild.map_poses.copy()
    ckpt["map_pose_count"] = np.int32(rebuild.n_prev)

    return FullSLAMResult(
        traj=traj_out,
        kf_poses=np.stack(kf_poses) if kf_poses else np.zeros((0, 3)),
        kf_scan_idx=np.asarray(kf_scan_idx, np.int64),
        n_loops=closer.n_loops,
        grid=state.logodds,
        chi2=closer.chi2,
        loops=np.asarray(loop_records, np.float32).reshape(-1, 6),
        loop_attempts=np.asarray(
            closer.attempt_records, np.float32
        ).reshape(-1, 10),
        ckpt=ckpt,
    )
