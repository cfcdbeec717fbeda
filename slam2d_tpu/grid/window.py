"""Static-size window extraction around a pose (hot-path optimization).

A scan only touches cells within max_range of the sensor, and the matcher
only reads the search space near the scan's endpoints — yet the naive
formulation gathers/scatters against the full [H, W] map. Extracting a
static-shape window via `dynamic_slice` (a fast contiguous copy), operating
on it, and writing it back keeps the random-access working set small (cache
resident) and cuts the full-map memory traffic out of the per-scan cost.

Window sizes are compile-time constants derived from config (max range,
search window, blur halo), so everything stays jit-static.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig


def blur_halo_cells(mcfg: MatcherConfig, resolution: float) -> int:
    sigma_cells = mcfg.sigma_m / resolution
    return max(4, int(math.ceil(3.0 * sigma_cells)))


def scan_window_cells(
    gcfg: GridConfig, sensor: SensorConfig, mcfg: MatcherConfig
) -> int:
    """Static window size covering everything one scan can touch or read:
    endpoints (max_range) + translation search + blur halo + slack.
    Rounded up to a multiple of 8 * coarse_factor; capped at the grid size."""
    half = (
        int(math.ceil(sensor.max_range / gcfg.resolution))
        + int(round(mcfg.search_xy / gcfg.resolution))
        + blur_halo_cells(mcfg, gcfg.resolution)
        + 8
    )
    size = 2 * half
    mult = 8 * mcfg.coarse_factor
    size = ((size + mult - 1) // mult) * mult
    return min(size, min(gcfg.height, gcfg.width))


def update_window_cells(
    gcfg: GridConfig, sensor: SensorConfig, mcfg: MatcherConfig | None = None
) -> int:
    """Static window size covering everything one scan's MAP UPDATE can
    touch: endpoints (max_range) + slack — WITHOUT the translation-search
    margin a match window needs (scatter/matmul update cost scales with the
    target window area, so the update should use the smallest safe window).

    Pass `mcfg` when the caller rebuilds the cached blurred search space
    from this window: the window then also covers the blur halo around
    every touched cell PLUS the halo ring `write_window_blur_exact` trims
    on writeback (2x halo total)."""
    half = int(math.ceil(sensor.max_range / gcfg.resolution)) + 8
    if mcfg is not None:
        half += 2 * blur_halo_cells(mcfg, gcfg.resolution)
    size = 2 * half
    size = ((size + 7) // 8) * 8
    return min(size, min(gcfg.height, gcfg.width))


def window_origin(center_rc, size: int, H: int, W: int):
    """Top-left (row, col) of a size x size window centered near center_rc,
    clamped so the window lies fully inside the grid."""
    r0 = jnp.clip(center_rc[0] - size // 2, 0, H - size)
    c0 = jnp.clip(center_rc[1] - size // 2, 0, W - size)
    return r0.astype(jnp.int32), c0.astype(jnp.int32)


def extract_window(arr, center_rc, size: int):
    """Returns (window [size, size], (r0, c0) origin)."""
    H, W = arr.shape
    r0, c0 = window_origin(center_rc, size, H, W)
    return lax.dynamic_slice(arr, (r0, c0), (size, size)), (r0, c0)


def write_window(arr, window, origin_rc):
    return lax.dynamic_update_slice(arr, window, origin_rc)


def write_window_interior(arr, window, origin_rc, margin: int):
    """Write back only the interior (margin-trimmed) part of a window —
    used when the window's outer ring was computed with a truncated
    neighborhood (e.g. a blur whose halo ran off the window edge)."""
    if margin == 0:
        return write_window(arr, window, origin_rc)
    inner = window[margin:-margin, margin:-margin]
    r0 = origin_rc[0] + margin
    c0 = origin_rc[1] + margin
    return lax.dynamic_update_slice(arr, inner, (r0, c0))


def write_window_blur_exact(arr, window, origin_rc, margin: int):
    """Write back a freshly-blurred window: trim the blur-halo ring EXCEPT
    on sides where the window is clamped against the array border — there
    the window edge IS the array edge, so the blur's zero padding matches
    reality and the ring is exact (otherwise border cells would go stale
    forever, since every later window clamps the same way)."""
    if margin == 0:
        return write_window(arr, window, origin_rc)
    H, W = arr.shape
    size = window.shape[0]
    r0, c0 = origin_rc
    row = lax.broadcasted_iota(jnp.int32, (size, size), 0)
    col = lax.broadcasted_iota(jnp.int32, (size, size), 1)
    keep = (
        ((row >= margin) | (r0 == 0))
        & ((row < size - margin) | (r0 == H - size))
        & ((col >= margin) | (c0 == 0))
        & ((col < size - margin) | (c0 == W - size))
    )
    old = lax.dynamic_slice(arr, (r0, c0), (size, size))
    merged = jnp.where(keep, window, old)
    return lax.dynamic_update_slice(arr, merged, (r0, c0))
