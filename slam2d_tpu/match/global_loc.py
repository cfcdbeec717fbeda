"""Global relocalization ("kidnapped robot"): find the robot's pose in a
prebuilt map with NO prior, by scoring one scan over EVERY pose.

For a fixed heading theta, the correlative score over all translations is
exactly a full-map cross-correlation between the blurred likelihood field
S and the scan's endpoint-splat image E_theta:

    score(v, theta) = sum_i S[v + e_i(theta)] = (S ★ E_theta)[v - center]

so the whole (x, y) sweep for one theta costs two FFTs and a pointwise
product — O(HW log HW) instead of the O(HW * beams) brute force the
reference's formulation would need per candidate. A full-circle theta grid
(default 72 x 5 deg) is swept in lax.map chunks, the global argmax seeds
`match_scan` for a sub-cell/sub-degree refinement.

This is the AMCL global-init analog, and pairs with run_localization
(run/frontend.py) which needs a starting pose estimate.

Border handling: raw circular FFT correlation wraps at map borders — a
pose near the border would read S from the opposite side. The sweep
therefore zero-pads S (and splats E in the padded frame) by the sensor's
max range, making the correlation exactly LINEAR, and masks out
displacements whose implied robot cell lies outside the map. Padded dims
round up to a multiple of 128 (FFT-friendly sizes). `pad_border=False`
restores the cheaper wrapping sweep for maps known to keep their walls
well inside the border. Scores are normalized per valid beam, same scale
as match_scan's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.grid.occupancy import scan_endpoints_local
from slam2d_tpu.match.correlative import build_search_space, match_scan


def _endpoint_image(pts, valid, theta, H, W, resolution):
    """Bilinear endpoint splat around the image CENTER cell for one
    heading. One-shot op (not the hot path), so the scatter-add is fine."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    ex = (c * pts[:, 0] - s * pts[:, 1]) / resolution + (W // 2)
    ey = (s * pts[:, 0] + c * pts[:, 1]) / resolution + (H // 2)
    # invalid beams carry NaN coordinates; their weight is 0 but
    # 0 * NaN = NaN would poison the whole splat (same guard as
    # correlative.score_offsets)
    ex = jnp.where(valid, ex, 0.0)
    ey = jnp.where(valid, ey, 0.0)
    x0 = jnp.floor(ex).astype(jnp.int32)
    y0 = jnp.floor(ey).astype(jnp.int32)
    fx = ex - x0.astype(jnp.float32)
    fy = ey - y0.astype(jnp.float32)
    img = jnp.zeros((H, W), jnp.float32)
    w = valid.astype(jnp.float32)
    for dy, dx, wt in (
        (0, 0, (1 - fy) * (1 - fx)),
        (0, 1, (1 - fy) * fx),
        (1, 0, fy * (1 - fx)),
        (1, 1, fy * fx),
    ):
        yy = jnp.clip(y0 + dy, 0, H - 1)
        xx = jnp.clip(x0 + dx, 0, W - 1)
        img = img.at[yy, xx].add(w * wt)
    return img


@functools.partial(
    jax.jit,
    static_argnames=("gcfg", "sensor", "n_theta", "theta_chunk", "pad"),
)
def _global_sweep(
    S, ranges, gcfg: GridConfig, sensor: SensorConfig,
    n_theta: int, theta_chunk: int, pad: int = 0,
):
    H, W = S.shape
    if pad:
        # zero-pad so the circular FFT correlation is exactly LINEAR for
        # every in-map robot cell: endpoints reach at most `pad` cells
        # from the robot, and the zero band absorbs both directions of
        # wrap. Round up to a multiple of 128 (FFT-friendly sizes;
        # extra zeros are harmless — the validity mask below restricts
        # the argmax to in-map robot cells).
        Hp = -(-(H + 2 * pad) // 128) * 128
        Wp = -(-(W + 2 * pad) // 128) * 128
        S_use = jnp.zeros((Hp, Wp), S.dtype).at[:H, :W].set(S)
    else:
        Hp, Wp = H, W
        S_use = S
    pts, valid = scan_endpoints_local(ranges, sensor)
    denom = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    FS = jnp.fft.rfft2(S_use.astype(jnp.float32))

    thetas = (
        jnp.arange(n_theta, dtype=jnp.float32) * (2.0 * jnp.pi / n_theta)
        - jnp.pi
    )

    def corr_batch(th):
        def one(theta):
            E = _endpoint_image(pts, valid, theta, Hp, Wp, gcfg.resolution)
            # correlation theorem: corr[d] = IFFT(conj(FFT(E)) * FFT(S))[d]
            return jnp.fft.irfft2(
                jnp.conj(jnp.fft.rfft2(E)) * FS, s=(Hp, Wp)
            )

        return jax.vmap(one)(th)

    corr = jax.lax.map(
        corr_batch, thetas.reshape(n_theta // theta_chunk, theta_chunk)
    ).reshape(n_theta, Hp, Wp) / denom
    # displacement d -> robot cell v = d + center (mod padded dims); only
    # displacements whose robot cell lies INSIDE the original map are
    # poses at all (the padded frame also enumerates robots in the zero
    # band, which score spuriously from partial overlap)
    rr = jnp.arange(Hp, dtype=jnp.int32)
    cc = jnp.arange(Wp, dtype=jnp.int32)
    vr_all = jnp.mod(rr + Hp // 2, Hp)
    vc_all = jnp.mod(cc + Wp // 2, Wp)
    in_map = (vr_all < H)[:, None] & (vc_all < W)[None, :]
    corr = jnp.where(in_map[None], corr, -jnp.inf)
    flat = jnp.argmax(corr.reshape(-1))
    ti, d = jnp.divmod(flat, Hp * Wp)
    dr, dc = jnp.divmod(d, Wp)
    best = corr.reshape(-1)[flat]
    # peak-uniqueness margin: best minus the best OUTSIDE a ~1 m
    # translation box around the winner (any heading). Perceptual
    # aliasing (look-alike rooms) shows up as a second near-equal peak
    # far away — margin ~0 — while a unique lock has margin >> 0.
    ex = max(int(round(1.0 / gcfg.resolution)), 2)
    over_th = jnp.max(corr, axis=0)                       # [Hp, Wp]
    # CIRCULAR distance: the FFT displacement domain wraps, and a winner
    # near displacement 0/Hp has its own shoulder at row Hp-1
    ar = jnp.abs(rr - dr)
    ac = jnp.abs(cc - dc)
    near = (
        (jnp.minimum(ar, Hp - ar)[:, None] <= ex)
        & (jnp.minimum(ac, Wp - ac)[None, :] <= ex)
    )
    second = jnp.max(jnp.where(near, -jnp.inf, over_th))
    margin = best - jnp.maximum(second, -1e9)
    vr = jnp.mod(dr + Hp // 2, Hp)
    vc = jnp.mod(dc + Wp // 2, Wp)
    x = gcfg.origin_x + (vc.astype(jnp.float32) + 0.5) * gcfg.resolution
    y = gcfg.origin_y + (vr.astype(jnp.float32) + 0.5) * gcfg.resolution
    return jnp.stack([x, y, thetas[ti]]), best, margin


def global_localize(
    logodds,
    ranges,
    gcfg: GridConfig,
    mcfg: MatcherConfig,
    sensor: SensorConfig,
    n_theta: int = 72,
    theta_chunk: int = 8,
    search_space=None,
    refine: bool = True,
    return_margin: bool = False,
    pad_border: bool = True,
):
    """Returns (pose [3], score) — or (pose, score, margin) with
    return_margin=True, where margin is the peak-uniqueness diagnostic
    (best score minus the best score outside ~1 m of the winner, any
    heading; near-zero under perceptual aliasing). Gate on it before
    trusting a relocalization in self-similar environments.

    `n_theta` full-circle headings are FFT-swept; the winner seeds a
    match_scan refinement over +-1 theta step and a few cells (sub-cell /
    sub-step accuracy). Set refine=False for the raw grid peak.

    `pad_border` (default True) zero-pads the sweep by the sensor's max
    range so poses near the map border score exactly (no FFT wrap
    aliasing); False keeps the cheaper same-size sweep."""
    assert n_theta % theta_chunk == 0, (n_theta, theta_chunk)
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution)
        if search_space is None
        else search_space
    )
    pad = (
        int(np.ceil(sensor.max_range / gcfg.resolution)) + 2
        if pad_border else 0
    )
    coarse, score, margin = _global_sweep(
        S, ranges, gcfg, sensor, n_theta, theta_chunk, pad
    )
    if not refine:
        return (coarse, score, margin) if return_margin else (coarse, score)
    import dataclasses

    step = 2.0 * np.pi / n_theta
    fine_mcfg = dataclasses.replace(
        mcfg,
        search_xy=max(2.5 * gcfg.resolution, 0.15),
        search_theta=step,
        n_theta=9,
        prior_xy_weight=0.0,
        prior_theta_weight=0.0,
        min_score=0.0,
    )
    pose, score = match_scan(
        logodds, ranges, coarse, gcfg, fine_mcfg, sensor, search_space=S
    )
    return (pose, score, margin) if return_margin else (pose, score)
