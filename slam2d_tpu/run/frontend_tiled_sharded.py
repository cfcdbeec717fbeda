"""Frontend on a MESH-SHARDED tile pool (SURVEY.md §3 "Map tiling" — the
tensor-parallel analog, end to end).

Same per-scan step as run/frontend_tiled.py, but the tile-slot axis is
sharded over a device mesh: each device's memory holds n_slots/n_devices
tiles, so WORLD CAPACITY scales with the mesh. The hot-path window is
assembled across shards with one psum (grid/tiles_sharded.py) and written
back owner-masked with no collective at all; pose tracking is computed
replicated (the per-scan compute is small next to the map — what the TP
axis buys here is map memory, not FLOPs).

The coords table stays replicated and host-managed, exactly like the
single-device pool; activation is the same host-side table update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from slam2d_tpu.config import FrontendConfig
from slam2d_tpu.core import se2
from slam2d_tpu.grid.occupancy import integrate_scan
from slam2d_tpu.grid.tiles import (
    FREE_SLOT,
    TileConfig,
    required_tiles,
    world_to_cell_global,
)
from slam2d_tpu.grid.tiles_sharded import (
    gather_region_sharded,
    scatter_region_sharded,
)
from slam2d_tpu.grid.window import blur_halo_cells
from slam2d_tpu.match.correlative import build_search_space, match_scan
from slam2d_tpu.run.frontend_tiled import (
    _np_between,
    _np_compose,
    _param_grid_cfg,
    tiled_window_cells,
)

TILE_AXIS = "tiles"


def make_tile_mesh(n_devices: int | None = None, axis: str = TILE_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


class ShardedTiledState(NamedTuple):
    tiles: jax.Array       # [N_pad, th, tw] log-odds, sharded over TILE_AXIS
    stiles: jax.Array      # [N_pad, th, tw] cached blurred field, sharded
    coords: jax.Array      # [N_pad + 1, 2] replicated slot table (trash last)
    pose: jax.Array
    prev_odom: jax.Array
    dist: jax.Array
    last_map_pose: jax.Array
    since_match: jax.Array


def sharded_tiled_init(
    tcfg: TileConfig, mesh: Mesh, start_pose=None, start_odom=None,
    axis: str = TILE_AXIS,
):
    """n_slots is rounded UP to a multiple of the mesh size (each shard
    holds an equal block); the trash row lives only in the coords table."""
    d = mesh.shape[axis]
    n_pad = ((tcfg.n_slots + d - 1) // d) * d
    pose = (
        jnp.zeros(3, jnp.float32)
        if start_pose is None
        else jnp.asarray(start_pose, jnp.float32)
    )
    odom = pose if start_odom is None else jnp.asarray(start_odom, jnp.float32)
    sh = NamedSharding(mesh, P(axis))
    zeros = lambda: jax.device_put(
        jnp.zeros((n_pad, tcfg.tile, tcfg.tile), jnp.float32), sh
    )
    return ShardedTiledState(
        tiles=zeros(),
        stiles=zeros(),
        coords=jnp.full((n_pad + 1, 2), FREE_SLOT, jnp.int32),
        pose=pose,
        prev_odom=odom + 0.0,
        dist=jnp.float32(0.0),
        last_map_pose=pose + 0.0,
        since_match=jnp.zeros(2, jnp.float32),
    )


def _sharded_step(state: ShardedTiledState, odom, ranges,
                  cfg: FrontendConfig, tcfg: TileConfig, axis: str):
    """One scan, called INSIDE shard_map: state.tiles/stiles are the local
    shard blocks; everything else is replicated. Mirrors
    frontend_tiled.tiled_frontend_step with sharded window access."""
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    halo = blur_halo_cells(cfg.matcher, tcfg.resolution)
    gparam = _param_grid_cfg(cfg, tcfg)

    delta = se2.between(state.prev_odom, odom)
    step_len = jnp.hypot(delta[0], delta[1])
    prior = se2.compose(state.pose, delta)
    in_boot = state.dist < cfg.bootstrap_dist
    since_m = state.since_match + jnp.stack(
        [step_len, jnp.abs(se2.wrap_angle(delta[2]))]
    )
    do_match = (~in_boot) & (
        (since_m[0] >= cfg.match_min_motion) | (since_m[1] >= cfg.match_min_rot)
    )

    def window_origin_rc(center_xy):
        rc = world_to_cell_global(center_xy, tcfg)
        return rc - win // 2

    def origin_xy_of(origin_rc):
        return (
            tcfg.origin_x + origin_rc[1].astype(jnp.float32) * tcfg.resolution,
            tcfg.origin_y + origin_rc[0].astype(jnp.float32) * tcfg.resolution,
        )

    def match_branch(_):
        orc = window_origin_rc(prior[:2])
        Sw = gather_region_sharded(
            state.stiles, state.coords, tcfg, orc, win, axis
        )
        return match_scan(
            None, ranges, prior, gparam, cfg.matcher, cfg.sensor,
            search_space=Sw, origin_xy=origin_xy_of(orc),
        )

    pose, score = jax.lax.cond(
        do_match, match_branch, lambda _: (prior, jnp.float32(-1.0)), None
    )
    since_m = jnp.where(do_match, jnp.zeros_like(since_m), since_m)

    moved = jnp.hypot(
        pose[0] - state.last_map_pose[0], pose[1] - state.last_map_pose[1]
    )
    rotated = jnp.abs(se2.wrap_angle(pose[2] - state.last_map_pose[2]))
    do_update = in_boot | (moved >= cfg.map_update_min_motion) | (
        rotated >= cfg.map_update_min_rot
    )

    def update_branch(_):
        orc = window_origin_rc(pose[:2])
        gw = gather_region_sharded(state.tiles, state.coords, tcfg, orc, win, axis)
        gw = integrate_scan(
            gw, pose, ranges, gparam, cfg.sensor, origin_xy=origin_xy_of(orc)
        )
        tiles = scatter_region_sharded(
            state.tiles, state.coords, tcfg, gw, orc, axis
        )
        Sw = build_search_space(gw, cfg.matcher, tcfg.resolution)
        stiles = scatter_region_sharded(
            state.stiles, state.coords, tcfg,
            Sw[halo:-halo, halo:-halo], orc + halo, axis,
        )
        return tiles, stiles

    tiles, stiles = jax.lax.cond(
        do_update, update_branch, lambda _: (state.tiles, state.stiles), None
    )
    last_map_pose = jnp.where(do_update, pose, state.last_map_pose)
    new_state = ShardedTiledState(
        tiles, stiles, state.coords, pose, odom, state.dist + step_len,
        last_map_pose, since_m,
    )
    return new_state, (pose, score)


def make_sharded_tiled_chunk_fn(
    cfg: FrontendConfig, tcfg: TileConfig, mesh: Mesh, axis: str = TILE_AXIS
):
    state_specs = ShardedTiledState(
        tiles=P(axis), stiles=P(axis), coords=P(None), pose=P(None),
        prev_odom=P(None), dist=P(), last_map_pose=P(None),
        since_match=P(None),
    )

    def chunk(state, odom_chunk, ranges_chunk):
        def body(s, inp):
            o, r = inp
            return _sharded_step(s, o, r, cfg, tcfg, axis)

        state, (traj, scores) = jax.lax.scan(
            body, state, (odom_chunk, ranges_chunk)
        )
        return state, traj, scores

    return jax.jit(
        jax.shard_map(
            chunk, mesh=mesh,
            in_specs=(state_specs, P(None), P(None)),
            out_specs=(state_specs, P(None), P(None)),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )


def run_sharded_tiled_frontend(
    log: dict, cfg: FrontendConfig, tcfg: TileConfig, mesh: Mesh | None = None,
    axis: str = TILE_AXIS, drift_margin: float = 2.0,
):
    """Host loop: same activation forecast as run_tiled_frontend, with the
    slot table sized to the PADDED (mesh-divisible) pool."""
    mesh = mesh or make_tile_mesh()
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk

    state = sharded_tiled_init(
        tcfg, mesh, start_pose=odom[0], start_odom=odom[0], axis=axis
    )
    chunk_fn = make_sharded_tiled_chunk_fn(cfg, tcfg, mesh, axis)
    reach = (
        cfg.sensor.max_range + cfg.matcher.search_xy
        + blur_halo_cells(cfg.matcher, tcfg.resolution) * tcfg.resolution
        + drift_margin
    )

    slot_of: dict[tuple[int, int], int] = {}
    n_slots = state.tiles.shape[0]

    def activate(coords, needed):
        coords_np = None
        for rc in needed:
            rc = (int(rc[0]), int(rc[1]))
            if rc in slot_of:
                continue
            slot = len(slot_of)
            if slot >= n_slots:
                raise RuntimeError(
                    f"tile pool exhausted ({n_slots} slots over "
                    f"{mesh.shape[axis]} devices); raise TileConfig.n_slots"
                )
            slot_of[rc] = slot
            if coords_np is None:
                coords_np = np.asarray(coords).copy()
            coords_np[slot] = rc
        return coords if coords_np is None else jnp.asarray(coords_np)

    trajs, scores = [], []
    for s in range(0, T, K):
        o = odom[s : s + K]
        r = ranges[s : s + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])

        est = np.asarray(state.pose)
        base = np.asarray(state.prev_odom)
        fx = [_np_compose(est, _np_between(base, o[t]))[:2] for t in range(len(o))]
        need = required_tiles(np.asarray(fx), reach, tcfg)
        state = state._replace(coords=activate(state.coords, need))

        state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        trajs.append(np.asarray(tr))
        scores.append(np.asarray(sc))

    return state, np.concatenate(trajs)[:T], np.concatenate(scores)[:T]
