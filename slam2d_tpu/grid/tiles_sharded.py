"""Mesh-sharded tile pool (SURVEY.md §3 "Map tiling" — the TP analog).

The tile pool's SLOT axis is sharded over the device mesh: map capacity
scales with device count (each device holds n_slots/n_shards tiles in its
memory). The coords table stays replicated (it is tiny and host-managed).

Window access inside shard_map:

- gather: every shard pastes the candidate tiles IT OWNS into a local
  window; one `psum` of the [size, size] window merges them (a window is
  ~1 MB — one small collective; the robot's working set is only
  the ~4 tiles under the current window, so this is bandwidth-trivial).
- scatter: updates are computed replicated; each shard writes back only the
  parts of tiles it owns (pure masking — no collective at all).

A slot's owner is `slot // slots_per_shard`; unknown tiles read as zeros
and writes to them are dropped, exactly like the single-device pool's
trash slot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam2d_tpu.grid.tiles import TileConfig, _span_candidates, lookup_slot


def _owner_local(coords, trc, n_local, axis):
    """(is_mine, local_index, found) for world tile trc on this shard."""
    slot, found = lookup_slot(coords, trc)
    me = jax.lax.axis_index(axis)
    owner = slot // n_local
    lidx = jnp.mod(slot, n_local)
    return (owner == me) & found, lidx, found


def gather_region_sharded(
    tiles_local, coords, cfg: TileConfig, origin_rc, size: int, axis: str
):
    """[size, size] window assembled across shards (call inside shard_map).

    tiles_local: [N_local, th, tw] — this shard's slot block.
    coords: [N_total(+1), 2] replicated table (same layout as TiledGrid).
    """
    tile = cfg.tile
    n_local = tiles_local.shape[0]
    base, offs = _span_candidates(origin_rc, size, tile)
    nc = offs.shape[0]

    out = jnp.zeros((size, size), jnp.float32)
    for i in range(nc):
        for j in range(nc):
            trc = base + jnp.stack([offs[i], offs[j]])
            mine, lidx, _ = _owner_local(coords, trc, n_local, axis)
            content = jnp.where(mine, tiles_local[lidx], 0.0)
            t0 = trc * tile
            dr = t0[0] - origin_rc[0]
            dc = t0[1] - origin_rc[1]
            padded = jnp.zeros((size + 2 * tile, size + 2 * tile), jnp.float32)
            padded = jax.lax.dynamic_update_slice(
                padded, content, (dr + tile, dc + tile)
            )
            out = out + padded[tile : tile + size, tile : tile + size]
    return jax.lax.psum(out, axis)


def scatter_region_sharded(
    tiles_local, coords, cfg: TileConfig, window, origin_rc, axis: str
):
    """Write a (replicated) window back; each shard updates only its own
    tiles. Returns the new local slot block. No collective needed."""
    tile = cfg.tile
    n_local = tiles_local.shape[0]
    size = window.shape[0]
    base, offs = _span_candidates(origin_rc, size, tile)
    nc = offs.shape[0]

    padded = jnp.zeros((size + 2 * tile, size + 2 * tile), window.dtype)
    padded = jax.lax.dynamic_update_slice(padded, window, (tile, tile))
    vmask = jnp.zeros_like(padded).at[
        tile : tile + size, tile : tile + size
    ].set(1.0)

    for i in range(nc):
        for j in range(nc):
            trc = base + jnp.stack([offs[i], offs[j]])
            mine, lidx, _ = _owner_local(coords, trc, n_local, axis)
            t0 = trc * tile
            dr = t0[0] - origin_rc[0] + tile
            dc = t0[1] - origin_rc[1] + tile
            part = jax.lax.dynamic_slice(padded, (dr, dc), (tile, tile))
            m = jax.lax.dynamic_slice(vmask, (dr, dc), (tile, tile)) * mine
            updated = tiles_local[lidx] * (1.0 - m) + part * m
            tiles_local = tiles_local.at[lidx].set(
                jnp.where(mine, updated, tiles_local[lidx])
            )
    return tiles_local
