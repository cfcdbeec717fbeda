"""Full SLAM (config 5) on the UNBOUNDED tiled world map — frontend
tracking on tiles, keyframe-relative loop-closure submaps, pose-graph
optimization, and a tiled map rebuild after corrections. This is the
MIT-Killian-scale configuration: no fixed grid bounds the trajectory.

Shares the submap/optimizer machinery with run/full_slam.py (submaps are
built in the anchor keyframe's frame on a small zero-centered grid, so
they never depend on world extent)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import FrontendConfig, GraphConfig, MatcherConfig
from slam2d_tpu.core import se2
from slam2d_tpu.graph import se2_graph
from slam2d_tpu.grid.occupancy import integrate_scan, world_to_cell
from slam2d_tpu.grid.tiles import (
    FREE_SLOT,
    TileConfig,
    TileTable,
    required_tiles,
    tiled_init,
)
from slam2d_tpu.grid.window import blur_halo_cells
from slam2d_tpu.match.correlative import build_search_space
from slam2d_tpu.run.frontend_tiled import (
    _np_between,
    _np_compose,
    _np_compose_batch,
    _param_grid_cfg,
    make_tiled_chunk_fn,
    tiled_frontend_init,
    tiled_window_cells,
)
from slam2d_tpu.run.full_slam import (
    FullSLAMResult,
    LoopCloser,
    default_loop_matcher,
    default_submap_grid,
)
from slam2d_tpu.grid.tiles import gather_region, scatter_region, world_to_cell_global


@functools.cache
def _make_tiled_rebuild_chunk(cfg: FrontendConfig, tcfg: TileConfig):
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    halo = blur_halo_cells(cfg.matcher, tcfg.resolution)
    gparam = _param_grid_cfg(cfg, tcfg)

    @jax.jit
    def rebuild_chunk(grid, sgrid, poses, scans, mask):
        def body(carry, inp):
            grid, sgrid = carry
            p, r, m = inp
            orc = world_to_cell_global(p[:2], tcfg) - win // 2
            gw = gather_region(grid, tcfg, orc, win)
            gw = integrate_scan(
                gw, p, r, gparam, cfg.sensor, enable=m,
                origin_xy=(
                    tcfg.origin_x + orc[1].astype(jnp.float32) * tcfg.resolution,
                    tcfg.origin_y + orc[0].astype(jnp.float32) * tcfg.resolution,
                ),
            )
            grid = scatter_region(grid, tcfg, gw, orc)
            Sw = build_search_space(gw, cfg.matcher, tcfg.resolution)
            sgrid = scatter_region(
                sgrid, tcfg, Sw[halo:-halo, halo:-halo], orc + halo
            )
            return (grid, sgrid), None

        (grid, sgrid), _ = jax.lax.scan(
            body, (grid, sgrid), (poses, scans, mask.astype(jnp.float32))
        )
        return grid, sgrid

    return rebuild_chunk


def make_tiled_rebuild_fn(cfg: FrontendConfig, tcfg: TileConfig,
                          capacity: int, chunk: int = 32):
    """Re-integrate up to `capacity` keyframe scans into FRESH tiles
    (coords table kept), refreshing the blurred-field tiles as well.
    Chunked like make_rebuild_fn: the host loops only over chunks that
    contain active keyframes."""
    rebuild_chunk = _make_tiled_rebuild_chunk(cfg, tcfg)

    def rebuild(coords, poses, scans, mask, n_active: int | None = None):
        n = capacity if n_active is None else min(int(n_active), capacity)
        n = ((max(n, 1) + chunk - 1) // chunk) * chunk
        n = min(n, capacity)
        grid = tiled_init(tcfg)._replace(coords=coords)
        sgrid = tiled_init(tcfg)._replace(coords=coords + 0)
        for s in range(0, n, chunk):
            grid, sgrid = rebuild_chunk(
                grid, sgrid, poses[s : s + chunk], scans[s : s + chunk],
                mask[s : s + chunk],
            )
        return grid, sgrid

    return rebuild


class IncrementalTiledRebuilder:
    """Tiled analog of full_slam.IncrementalRebuilder: replay keyframe
    integration from a chunk-aligned cached prefix of (tile pool, blurred
    pool) instead of fresh tiles, starting at the first keyframe whose
    RENDERED (snapped) pose moved. Valid because tile slots are
    append-only (TileTable.activate never evicts): a slot activated after
    the cache snapshot holds zeros there — exactly a fresh tile."""

    def __init__(self, cfg: FrontendConfig, tcfg: TileConfig,
                 capacity: int, chunk: int = 32, eps_cells: float = 0.25):
        self.tcfg = tcfg
        self.capacity = capacity
        self.chunk = chunk
        self.eps_xy = eps_cells * tcfg.resolution
        self.eps_th = eps_cells * tcfg.resolution / max(cfg.sensor.max_range, 1e-6)
        self._rebuild_chunk = _make_tiled_rebuild_chunk(cfg, tcfg)
        self.map_poses = np.zeros((capacity, 3), np.float32)
        self.n_prev = 0
        self.cache = None          # (grid, sgrid, coords_np) at cache_k
        self.cache_k = 0

    def restore(self, map_poses, n_prev: int):
        self.map_poses[: len(map_poses)] = np.asarray(map_poses, np.float32)
        self.n_prev = int(n_prev)
        self.cache = None
        self.cache_k = 0

    def _cache_compatible(self, coords_np):
        """Every slot active at snapshot time must still hold the same
        tile coordinate (activation is append-only, but verify)."""
        old = self.cache[2]
        act = old[:, 0] > FREE_SLOT
        return bool(np.array_equal(old[act], coords_np[act]))

    def __call__(self, coords, poses, scans, mask, n_active: int | None = None):
        from slam2d_tpu.run.full_slam import snap_render_poses

        n = self.capacity if n_active is None else min(int(n_active), self.capacity)
        n = max(n, 1)
        poses, k0 = snap_render_poses(
            np.asarray(poses), n, self.map_poses, self.n_prev,
            self.eps_xy, self.eps_th,
        )
        coords_np = np.asarray(coords)
        if (
            self.cache is not None
            and self.cache_k <= k0
            and self._cache_compatible(coords_np)
        ):
            grid = self.cache[0]._replace(coords=coords)
            sgrid = self.cache[1]._replace(coords=coords + 0)
            start = self.cache_k
        else:
            grid = tiled_init(self.tcfg)._replace(coords=coords)
            sgrid = tiled_init(self.tcfg)._replace(coords=coords + 0)
            start = 0
            self.cache, self.cache_k = None, 0
        n_end = min(((n + self.chunk - 1) // self.chunk) * self.chunk,
                    self.capacity)
        poses_j = jnp.asarray(poses)
        for s in range(start, n_end, self.chunk):
            grid, sgrid = self._rebuild_chunk(
                grid, sgrid, poses_j[s : s + self.chunk],
                scans[s : s + self.chunk], mask[s : s + self.chunk],
            )
            # never cache the pools that will be RETURNED: they become
            # the frontend state and the next chunk_fn donates them
            if s + self.chunk <= k0 and s + self.chunk < n_end:
                self.cache = (grid, sgrid, coords_np)
                self.cache_k = s + self.chunk
        self.map_poses[:n] = poses[:n]
        self.n_prev = n
        return grid, sgrid


def fullslam_tiled_ckpt_template(
    cfg: FrontendConfig, tcfg: TileConfig, graph_cfg: GraphConfig
):
    """Empty checkpoint bundle for the TILED full-SLAM pipeline — same
    schema as full_slam.fullslam_ckpt_template with the tiled frontend
    state (tile pool + coords table; the host TileTable is reconstructed
    from the coords on resume)."""
    Kmax = graph_cfg.max_nodes
    B = cfg.sensor.n_beams
    return {
        "frontend": tiled_frontend_init(tcfg),
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
        "map_poses": np.zeros((Kmax, 3), np.float32),
        "map_pose_count": np.int32(0),
        # submap-cache anchor — see full_slam.fullslam_ckpt_template
        "loop_cache_anchor": np.int32(-1),
    }


def run_full_slam_tiled(
    log: dict,
    cfg: FrontendConfig,
    tcfg: TileConfig,
    graph_cfg: GraphConfig,
    loop_matcher: MatcherConfig | None = None,
    submap_halfwidth: int = 3,
    odom_edge_info: float = 50.0,
    loop_edge_info: float = 200.0,
    drift_margin: float = 2.0,
    optimizer: str = "auto",
    resume: dict | None = None,
    scan_index_offset: int = 0,
    incremental_rebuild: bool = True,
    defer_accept: bool = True,
):
    """optimizer: "dense" (one Cholesky over all keyframes), "schur"
    (keyframe-block eliminated — the form that scales/distributes), or
    "schur_sharded" (block axis over all visible devices).

    resume / scan_index_offset: continue from FullSLAMResult.ckpt of a
    previous run, as in run_full_slam."""
    loop_matcher = loop_matcher or default_loop_matcher(graph_cfg)
    odom_np = np.asarray(log["odom"], np.float32)
    ranges_np = np.asarray(log["ranges"], np.float32)
    T = len(odom_np)
    K = cfg.chunk

    chunk_fn = make_tiled_chunk_fn(cfg, tcfg)
    submap_cfg = default_submap_grid(cfg)
    rebuild_tiles = IncrementalTiledRebuilder(
        cfg, tcfg, graph_cfg.max_nodes,
        # eps 0 = nothing snaps, every rebuild replays from scratch (the
        # A/B baseline: the naive full re-raycast per accepted loop)
        eps_cells=0.25 if incremental_rebuild else 0.0,
    )

    reach = (
        cfg.sensor.max_range + cfg.matcher.search_xy
        + blur_halo_cells(cfg.matcher, tcfg.resolution) * tcfg.resolution
        + drift_margin
    )

    table = TileTable(tcfg)
    if resume is not None:
        state = jax.tree.map(jnp.asarray, resume["frontend"])
        graph = se2_graph.HostGraph.from_arrays(graph_cfg, resume["graph"])
        # rebuild the host slot table from the restored coords (slots are
        # assigned sequentially, so insertion order == slot index)
        coords_np = np.asarray(state.grid.coords)
        for slot in range(tcfg.n_slots):
            if coords_np[slot, 0] > FREE_SLOT:
                table.slot_of[(int(coords_np[slot, 0]), int(coords_np[slot, 1]))] = slot
        kc = int(resume["kf_count"])
        kf_poses = [np.asarray(resume["kf_poses"][k]) for k in range(kc)]
        kf_scans = [np.asarray(resume["kf_scans"][k]) for k in range(kc)]
        kf_scan_idx = [int(resume["kf_scan_idx"][k]) for k in range(kc)]
        nl = int(resume["n_loops"])
        loop_records = [tuple(np.asarray(resume["loops"][k])) for k in range(nl)]
        n_loops = nl
        chi2 = float(resume["chi2"])
        init_cooldown = int(resume["cooldown"])
        init_last_kf = np.asarray(resume["last_kf_pose"]) if kc > 0 else None
        if "map_poses" in resume:
            rebuild_tiles.restore(resume["map_poses"], resume["map_pose_count"])
        init_cache_anchor = (
            int(resume["loop_cache_anchor"])
            if "loop_cache_anchor" in resume else -1
        )
    else:
        state = tiled_frontend_init(
            tcfg, start_pose=odom_np[0], start_odom=odom_np[0]
        )
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
        # activate tiles for corrected keyframes, rebuild both tile sets,
        # and patch the live frontend. `corr_np` is the LEFT correction
        # transform (LoopCloser._accept) — applied to the device pose it
        # stays valid when a pipelined chunk has already advanced it.
        nonlocal state
        Tc = jnp.asarray(corr_np, jnp.float32)
        need = required_tiles(np.stack(kf_poses)[:, :2], reach, tcfg)
        grid = table.activate(state.grid, need)
        nk = len(kf_poses)
        Kmax = graph_cfg.max_nodes
        poses_buf = np.zeros((Kmax, 3), np.float32)
        scans_buf = np.zeros((Kmax, ranges_np.shape[1]), np.float32)
        mask_buf = np.zeros(Kmax, np.float32)
        poses_buf[:nk] = np.stack(kf_poses)
        scans_buf[:nk] = np.stack(kf_scans)
        mask_buf[:nk] = 1.0
        new_grid, new_sgrid = rebuild_tiles(
            grid.coords, jnp.asarray(poses_buf), jnp.asarray(scans_buf),
            jnp.asarray(mask_buf), n_active=nk,
        )
        new_pose = se2.compose(Tc, state.pose)
        state = state._replace(
            grid=new_grid,
            sgrid=new_sgrid,
            pose=new_pose,
            last_map_pose=new_pose + 0.0,
        )

    closer = LoopCloser(
        cfg, graph_cfg, loop_matcher, submap_cfg, submap_halfwidth,
        graph, kf_poses, kf_scans, kf_scan_idx, ranges_np, traj_out,
        optimizer, loop_edge_info, scan_index_offset, apply_correction,
        loop_records, n_loops=n_loops, chi2=chi2,
        cache_anchor=init_cache_anchor, defer_accept=defer_accept,
    )

    # ---- main host loop over chunks (software-pipelined fetch) ------------
    # Same pipelining as run_full_slam: dispatch chunk c, THEN drain chunk
    # c-1's outputs so the host round trip overlaps device compute.
    # The tile-activation forecast composes host-known ODOMETRY onto the
    # last PROCESSED chunk's pose — one extra chunk of staleness is well
    # inside `reach`'s margin (sensor range + search window vs ~meters of
    # drift); loop-accept corrections land before the forecast via resolve.
    emitted_upto = -1   # last traj_out row written (run-local index)
    last_kf_pose = init_last_kf
    cooldown = init_cooldown
    est = np.asarray(state.pose)
    base = np.asarray(state.prev_odom)
    pend = None          # dispatched-but-unprocessed chunk outputs
    pend_T = None        # left transform owed to pend's rows

    def process_pending():
        nonlocal pend, pend_T, est, base, emitted_upto, last_kf_pose, cooldown
        if pend is None:
            return
        tr, est_new = jax.device_get((pend["tr"], pend["pose"]))
        n_here = pend["n"]
        tr = np.asarray(tr)[:n_here]
        est = np.asarray(est_new, np.float32)
        base = pend["base"]
        if pend_T is not None:
            tr = _np_compose_batch(pend_T, tr)
            est = np.asarray(_np_compose(pend_T, est), np.float32)
            pend_T = None
        s0 = pend["s0"]
        traj_out[s0 : s0 + n_here] = tr
        emitted_upto = s0 + n_here - 1

        for t in range(n_here):
            scan_i = s0 + t
            pose = tr[t]
            if last_kf_pose is None:
                last_kf_pose = pose
                admit_keyframe(pose, scan_i)
                continue
            moved = np.hypot(*(pose[:2] - last_kf_pose[:2]))
            rot = abs((pose[2] - last_kf_pose[2] + np.pi) % (2 * np.pi) - np.pi)
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

        # tile activation forecast for this chunk (est/base from the last
        # PROCESSED chunk; odometry bridges the in-flight one)
        fx = [
            _np_compose(est, _np_between(base, o[t]))[:2] for t in range(len(o))
        ]
        need = required_tiles(np.asarray(fx), reach, tcfg)
        grid = table.activate(state.grid, need)
        sgrid = state.sgrid._replace(coords=grid.coords + 0)
        state = state._replace(grid=grid, sgrid=sgrid)

        state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        # pose copied: chunk_fn donates its input state, so the next
        # dispatch deletes the captured buffer before process_pending
        cand = {
            "s0": s0, "n": min(K, T - s0), "tr": tr,
            "pose": state.pose + 0.0, "base": o[-1],
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
    while closer.pending or closer.pending_accept is not None:
        # drain fully: an accept can re-issue attempts, and a deferred
        # accept still needs its finalize pass
        cd, est, nl, _ = closer.resolve(est, emitted_upto)
        if cd is not None:
            cooldown = cd
        if nl is not None:
            last_kf_pose = nl
    ckpt = fullslam_tiled_ckpt_template(cfg, tcfg, graph_cfg)
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
    ckpt["map_poses"] = rebuild_tiles.map_poses.copy()
    ckpt["map_pose_count"] = np.int32(rebuild_tiles.n_prev)

    return FullSLAMResult(
        traj=traj_out,
        kf_poses=np.stack(kf_poses) if kf_poses else np.zeros((0, 3)),
        kf_scan_idx=np.asarray(kf_scan_idx, np.int64),
        n_loops=closer.n_loops,
        grid=state.grid,   # the TiledGrid (stitch with grid.tiles.stitch_tiles)
        chi2=closer.chi2,
        loops=np.asarray(loop_records, np.float32).reshape(-1, 6),
        loop_attempts=np.asarray(
            closer.attempt_records, np.float32
        ).reshape(-1, 10),
        ckpt=ckpt,
    )
