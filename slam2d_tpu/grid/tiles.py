"""Tiled, world-anchored occupancy map (SURVEY.md §2 L1, §4.2).

The reference grows its NumPy grid when the robot nears a border — a
reshape XLA cannot express. Here the world is an unbounded integer lattice
of fixed-size tiles; the device holds a fixed pool of tile slots:

    tiles  [N+1, th, tw]  log-odds content per slot (slot N = trash/void)
    coords [N+1, 2]       world tile index (row, col) per slot, INT_MIN=free

Activating a tile when the robot approaches new territory is a HOST-side
table update (assign a free slot, zero it) — never a reshape, so every
device computation keeps static shapes. Device-side ops:

- `lookup(coords_q)`: tile index -> slot by comparing against the table
  (O(N) vectorized compare; N is tens).
- `gather_region` / `scatter_region`: assemble or write back a static-size
  [size, size] window that may span a (static) few tiles — the same window
  the hot path already uses (grid/window.py), so the frontend runs on a
  tiled world with the identical matcher/update kernels.

Missing tiles read as unknown (log-odds 0); writes to missing tiles land in
the trash slot (slot N) and are discarded — the host's activation forecast
(odometry + max range) makes that a never-in-practice safety valve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FREE_SLOT = np.int32(-(2**31))  # sentinel coord for an unused slot


@dataclasses.dataclass(frozen=True)
class TileConfig:
    tile: int = 512            # cells per tile side
    n_slots: int = 64          # device tile-pool capacity (excl. trash slot)
    resolution: float = 0.05   # meters per cell
    # world position of cell (0, 0) of tile (0, 0)
    origin_x: float = 0.0
    origin_y: float = 0.0
    l_clamp: float = 10.0


class TiledGrid(NamedTuple):
    tiles: jax.Array    # [N+1, th, tw] float32
    coords: jax.Array   # [N+1, 2] int32 world tile indices; FREE_SLOT=empty


def tiled_init(cfg: TileConfig) -> TiledGrid:
    n = cfg.n_slots + 1
    return TiledGrid(
        tiles=jnp.zeros((n, cfg.tile, cfg.tile), jnp.float32),
        coords=jnp.full((n, 2), FREE_SLOT, jnp.int32),
    )


def world_to_cell_global(xy, cfg: TileConfig):
    """World (x, y) -> global integer (row, col) on the unbounded lattice."""
    col = jnp.floor((xy[..., 0] - cfg.origin_x) / cfg.resolution)
    row = jnp.floor((xy[..., 1] - cfg.origin_y) / cfg.resolution)
    return jnp.stack([row, col], axis=-1).astype(jnp.int32)


def lookup_slot(coords_table, tile_rc):
    """Slot index for world tile (row, col); the trash slot if absent."""
    n = coords_table.shape[0] - 1
    hit = jnp.all(coords_table[:n] == tile_rc[None, :], axis=1)
    found = jnp.any(hit)
    slot = jnp.argmax(hit)
    return jnp.where(found, slot, n).astype(jnp.int32), found


def required_tiles(poses_xy: np.ndarray, reach_m: float, cfg: TileConfig):
    """HOST helper: set of world tile (row, col) a trajectory segment plus
    sensor reach can touch. Conservative bounding boxes per pose."""
    need = set()
    t = cfg.tile * cfg.resolution
    for x, y in np.asarray(poses_xy).reshape(-1, 2):
        r0 = math.floor((y - cfg.origin_y - reach_m) / t)
        r1 = math.floor((y - cfg.origin_y + reach_m) / t)
        c0 = math.floor((x - cfg.origin_x - reach_m) / t)
        c1 = math.floor((x - cfg.origin_x + reach_m) / t)
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                need.add((r, c))
    return need


class TileTable:
    """HOST-side mirror of the slot table; owns activation decisions."""

    def __init__(self, cfg: TileConfig):
        self.cfg = cfg
        self.slot_of: dict[tuple[int, int], int] = {}

    def activate(self, grid: TiledGrid, tiles_needed) -> TiledGrid:
        """Assign free slots to any unseen tiles; returns updated grid.
        Raises if the pool is exhausted (capacity is a config decision)."""
        coords = None
        for rc in tiles_needed:
            rc = (int(rc[0]), int(rc[1]))
            if rc in self.slot_of:
                continue
            slot = len(self.slot_of)
            if slot >= self.cfg.n_slots:
                raise RuntimeError(
                    f"tile pool exhausted ({self.cfg.n_slots} slots); "
                    "raise TileConfig.n_slots"
                )
            self.slot_of[rc] = slot
            if coords is None:
                coords = np.asarray(grid.coords).copy()
            coords[slot] = rc
        if coords is not None:
            grid = grid._replace(coords=jnp.asarray(coords))
        return grid


def stitch_tiles(grid: TiledGrid, cfg: TileConfig):
    """HOST helper: assemble all active tiles into one dense array for
    rendering/export. Returns (dense [H, W] np.ndarray, origin_xy)."""
    coords = np.asarray(grid.coords[:-1])
    tiles = np.asarray(grid.tiles[:-1])
    active = coords[:, 0] > FREE_SLOT
    if not active.any():
        return np.zeros((cfg.tile, cfg.tile), np.float32), (cfg.origin_x, cfg.origin_y)
    rc = coords[active]
    r0, c0 = rc[:, 0].min(), rc[:, 1].min()
    r1, c1 = rc[:, 0].max() + 1, rc[:, 1].max() + 1
    H = int(r1 - r0) * cfg.tile
    W = int(c1 - c0) * cfg.tile
    dense = np.zeros((H, W), np.float32)
    for k in np.flatnonzero(active):
        rr = int(coords[k, 0] - r0) * cfg.tile
        cc = int(coords[k, 1] - c0) * cfg.tile
        dense[rr : rr + cfg.tile, cc : cc + cfg.tile] = tiles[k]
    origin = (
        cfg.origin_x + int(c0) * cfg.tile * cfg.resolution,
        cfg.origin_y + int(r0) * cfg.tile * cfg.resolution,
    )
    return dense, origin


def _span_candidates(origin_rc, size: int, tile: int):
    """Static-count candidate tile indices covering a window: per axis the
    window spans at most ceil(size/tile)+1 tiles."""
    nc = size // tile + 2
    base = jnp.floor_divide(origin_rc, tile)  # tile of the window origin
    offs = jnp.arange(nc, dtype=jnp.int32)
    return base, offs  # candidate tile (base[0]+i, base[1]+j)


def _span_onehots(coords, origin_rc, size: int, tile: int):
    """Candidate-tile bookkeeping for a [size, size] window as ONE-HOT
    operands for the slot-select and placement contractions (run at
    HIGHEST precision, so they copy exactly).

    Returns (oh_found [nc, nc, S], oh_all [nc, nc, S], R [nc, size, tile],
    C [nc, size, tile], rmask [nc, tile], cmask [nc, tile]) where
    oh_found zeroes missing tiles (reads see zeros) and oh_all routes
    them to the trash slot (writes are discarded); R/C place tile rows/
    cols into window rows/cols: R[a, r, q] = 1 iff window row r is tile
    candidate a's row q."""
    nc = size // tile + 2
    S = coords.shape[0]
    n = S - 1
    base = jnp.floor_divide(origin_rc, tile)
    offs = jnp.arange(nc, dtype=jnp.int32)
    trc = jnp.stack(
        jnp.meshgrid(base[0] + offs, base[1] + offs, indexing="ij"), -1
    )                                                        # [nc, nc, 2]
    hit = jnp.all(coords[None, None, :n, :] == trc[:, :, None, :], axis=-1)
    found = jnp.any(hit, axis=-1)                            # [nc, nc]
    slot = jnp.where(found, jnp.argmax(hit, axis=-1), n)
    oh_all = jax.nn.one_hot(slot, S, dtype=jnp.float32)      # [nc, nc, S]
    oh_found = oh_all * found[..., None].astype(jnp.float32)

    dr = (base[0] + offs) * tile - origin_rc[0]              # [nc]
    dc = (base[1] + offs) * tile - origin_rc[1]
    iw = jnp.arange(size, dtype=jnp.int32)
    it = jnp.arange(tile, dtype=jnp.int32)
    R = (iw[None, :, None] == dr[:, None, None] + it[None, None, :]).astype(
        jnp.float32
    )                                                        # [nc, size, tile]
    C = (iw[None, :, None] == dc[:, None, None] + it[None, None, :]).astype(
        jnp.float32
    )
    rmask = (
        (dr[:, None] + it[None, :] >= 0) & (dr[:, None] + it[None, :] < size)
    ).astype(jnp.float32)                                    # [nc, tile]
    cmask = (
        (dc[:, None] + it[None, :] >= 0) & (dc[:, None] + it[None, :] < size)
    ).astype(jnp.float32)
    return oh_found, oh_all, R, C, rmask, cmask


_HI = jax.lax.Precision.HIGHEST  # one-hot selections must not bf16-truncate


def gather_region(grid: TiledGrid, cfg: TileConfig, origin_rc, size: int):
    """Assemble the [size, size] window whose global top-left cell is
    origin_rc (row, col). Missing tiles read as zeros.

    Formulated as one-hot contractions (slot selection over the pool +
    row/col placement) at HIGHEST precision, so the copy is exact."""
    tile = cfg.tile
    oh_found, _, R, C, _, _ = _span_onehots(
        grid.coords, origin_rc, size, tile
    )
    sel = jnp.einsum(
        "abs,shw->abhw", oh_found, grid.tiles, precision=_HI
    )                                                        # [nc, nc, t, t]
    tmp = jnp.einsum("arq,abqp->abrp", R, sel, precision=_HI)
    return jnp.einsum("abrp,bwp->rw", tmp, C, precision=_HI)


def scatter_region(grid: TiledGrid, cfg: TileConfig, window, origin_rc):
    """Write a [size, size] window back: each covered tile's overlap is
    replaced. Writes to missing tiles fall into the trash slot.

    One-hot matmul form (see gather_region): project the window into each
    candidate tile frame, then apply ONE pool-wide delta — instead of one
    serialized dynamic-index pool scatter per candidate."""
    tile = cfg.tile
    size = window.shape[0]
    _, oh_all, R, C, rmask, cmask = _span_onehots(
        grid.coords, origin_rc, size, tile
    )
    w = window.astype(jnp.float32)
    t1 = jnp.einsum("arq,rw->aqw", R, w, precision=_HI)      # [nc, t, size]
    part = jnp.einsum("aqw,bwp->abqp", t1, C, precision=_HI)  # [nc, nc, t, t]
    m = rmask[:, None, :, None] * cmask[None, :, None, :]     # [nc, nc, t, t]
    sel = jnp.einsum(
        "abs,shw->abhw", oh_all, grid.tiles, precision=_HI
    )
    delta = (part - sel) * m
    tiles = grid.tiles + jnp.einsum(
        "abs,abhw->shw", oh_all, delta, precision=_HI
    )
    return grid._replace(tiles=tiles)
