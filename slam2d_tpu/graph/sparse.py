"""Matrix-free SE(2) pose-graph Gauss-Newton for large graphs (SURVEY §9
step 5, second half: "dense-block first, then segment_sum sparse").

`se2_graph.optimize` materializes the dense normal matrix H as [3K, 3K]
(38 MB at K=1024, ~3.6 GB at 10^4 keyframes) and `graph/schur.py` bounds
it by blocks but still builds dense per-block + separator systems with
no bound on separator growth. This module never materializes ANY
[3K, 3K] object: memory is O(E) edge blocks + O(K) 3x3 diagonal/
off-diagonal blocks + O(L*K) for the loop-correction columns.

Array formulation — exploit the SLAM graph's shape instead of a
general sparse-Cholesky (sequential, pointer-chasing, wrong for XLA):

- A SLAM pose graph is a CHAIN (odometry edges k -> k+1) plus a sparse
  set of L loop-closure edges. All diagonal blocks plus the chain
  off-diagonals form a block-TRIDIAGONAL SPD matrix T; T factors once
  per GN iteration with a block-Thomas recurrence (lax.scan over K
  tiny 3x3 ops) and applies in LOG depth via two
  `jax.lax.associative_scan`s over affine maps (x_k = A_k x_{k-1} + c_k
  composes associatively).
- `optimize_cg`: each GN step solves H delta = -b with fixed-iteration
  PCG. H applies matrix-free (gather at edge endpoints, batched 3x3
  block products, segment_sum back — [E, 3]-sized ops on the RARE
  optimizer path, not the per-scan hot path the no-scatter rule in
  CLAUDE.md targets). The preconditioner is ADDITIVE TWO-LEVEL:
  T^-1 (exact on local modes) + W Hc^-1 W^T, where W spans chain-linear
  interpolation over `sparse_coarse_stride`-spaced anchors (global
  smooth modes) plus the 6 basis vectors of each loop edge's endpoints
  (deflating the loop-coupling outliers). Hc is a small dense
  [3*K/stride + 6L]^2 Cholesky — bounded by anchors + loops, not
  keyframes.
- `optimize_hier`: for K in the thousands the fine system's condition
  (~K^2 * info ratio ~ 1e7 at 4096) puts f32 residual noise over the
  lowest modes at O(1) m — no f32 Krylov method can recover them
  (measured: flat PCG stalls at err 1.4 m). The hierarchical form
  solves a stride-subsampled ANCHOR graph first — chain measurements
  composed between anchors with a segmented associative scan over
  SE(2), dense GN on the short anchor chain where f32 is accurate —
  then prolongs the correction rigidly per segment and polishes with
  `optimize_cg`. Measured on the 4096-node serpentine with realistic
  loop density: err 3.37 -> 0.056 m where flat PCG stalls at 1.37.
- Gauge fixing: node 0 (and inactive slots) are clamped EXACTLY by
  projection (masked matvec + identity diagonal) instead of the dense
  path's 1e8 anchor prior — a measured necessity, not a nicety: the
  anchor puts condition(T) at ~1e12, where the f32 Thomas solve loses
  half its digits (apply error 1.4e-2).

Rejected design (measured, round 4): solving the loop coupling EXACTLY
by the Woodbury identity H^-1 = T^-1 - T^-1 U (S^-1 + U^T T^-1 U)^-1
U^T T^-1 — algebraically elegant, numerically doomed: nearby loop
endpoints have nearly identical long-range T^-1 responses, so the
capacitance matrix measured cond ~ 1e16 and even an f64 Woodbury
disagreed with a direct f64 solve by 170%. As a jittered PRECONDITIONER
block (the W enrichment above) the same near-dependence is harmless.

Capacity contract: `cfg.sparse_max_loops` is the STATIC loop-edge
capacity (the first Lmax loop edges in insertion order are deflated /
re-anchored; overflow edges cost extra CG iterations and coarse-solve
accuracy, so drivers should size it >= accepted-loop capacity —
full-SLAM's cooldown gate bounds the accept rate).

Numerics: runs under jax.default_matmul_precision("highest") —
reduced-precision matmuls (bf16, or a GPU's default TF32 for f32) make H
indefinite (see se2_graph._edge_blocks note). Robust kernels / GNC re-weight edges per GN iteration exactly as
the dense path does.

Reference parity anchor: the reference's backend is a dense
Python/NumPy GN over an edge list (SURVEY §4.4); this is its
scale-unbounded accelerator form — `optimize_cg` matches `se2_graph.optimize`
on the small loop graphs and `optimize_hier` runs where dense H cannot
exist (tests/test_sparse_graph.py: 4096 nodes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.core import se2
from slam2d_tpu.graph.se2_graph import PoseGraph, _edge_blocks, _robust_of

_seg = functools.partial(jax.ops.segment_sum, indices_are_sorted=False)


def _assemble_sparse(poses, g: PoseGraph, robust, damping: float,
                     psum_axis=None):
    """Edge blocks -> (D, O, b, chi, free, blocks) with NO [3K, 3K]
    object.

    D: [K, 3, 3] diagonal blocks (ALL edges' Hii/Hjj + damping),
       gauge/inactive-projected (clamped rows/cols -> identity).
    O: [K, 3, 3] chain off-diagonal blocks, O[k] = block (k, k+1)
       (only |i-j| == 1 edges; loop off-diagonals stay edge-resident),
       projected.
    b: [K, 3] gradient, projected; chi: scalar robustified cost.
    free: [K] f32 mask — 1 for nodes the solve may move (active, k>0).
    """
    K = poses.shape[0]
    blocks = _edge_blocks(
        poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, robust
    )
    Hii, Hij, Hjj, bi, bj, chi = blocks
    ei, ej = g.edges_ij[:, 0], g.edges_ij[:, 1]
    free = (
        g.node_mask & (jnp.arange(K) > 0)
    ).astype(jnp.float32)
    D = _seg(Hii, ei, num_segments=K) + _seg(Hjj, ej, num_segments=K)
    fwd = (ej == ei + 1).astype(jnp.float32)[:, None, None]
    rev = (ei == ej + 1).astype(jnp.float32)[:, None, None]
    O = _seg(Hij * fwd, ei, num_segments=K) + _seg(
        jnp.swapaxes(Hij, 1, 2) * rev, ej, num_segments=K
    )
    b = _seg(bi, ei, num_segments=K) + _seg(bj, ej, num_segments=K)
    chi = jnp.sum(chi)
    if psum_axis is not None:
        # edge-sharded assembly (optimize_cg_sharded): each shard summed
        # its LOCAL edge slice; reduce across devices before the (replicated)
        # projection/damping below
        D = jax.lax.psum(D, psum_axis)
        O = jax.lax.psum(O, psum_axis)
        b = jax.lax.psum(b, psum_axis)
        chi = jax.lax.psum(chi, psum_axis)
    eye = jnp.eye(3, dtype=jnp.float32)
    # projection: clamped nodes get the identity block, their couplings 0
    D = free[:, None, None] * (D + damping * eye) + (
        1.0 - free[:, None, None]
    ) * eye
    free_pair = free[:-1] * free[1:]
    O = O.at[: K - 1].multiply(free_pair[:, None, None])
    O = O.at[K - 1].set(0.0)
    b = b * free[:, None]
    return D, O, b, chi, free, (Hii, Hij, Hjj)


def _tridiag_factor(D, O):
    """Block-Thomas factorization of the SPD block-tridiagonal T =
    tridiag(O^T, D, O): C[k] = D[k] - O[k-1]^T C[k-1]^-1 O[k-1].
    Returns Cinv [K, 3, 3]. O(K) sequential 3x3 work, once per GN
    iteration (the per-solve applies are log-depth)."""

    def step(cinv_prev, inp):
        d, o_prev = inp
        c = d - o_prev.T @ cinv_prev @ o_prev
        cinv = jnp.linalg.inv(c)
        return cinv, cinv

    o_shift = jnp.concatenate([jnp.zeros((1, 3, 3), jnp.float32), O[:-1]])
    _, Cinv = jax.lax.scan(step, jnp.zeros((3, 3), jnp.float32),
                           (D, o_shift))
    return Cinv


def _affine_scan(A, C):
    """X[k] = A[k] X[k-1] + C[k] (X[-1] = 0) for all k, via log-depth
    associative_scan over affine-map composition. A: [K, 3, 3],
    C: [K, 3, N] — N right-hand sides share the SAME transition
    matrices, so the multi-RHS case (the 6L Woodbury columns) costs one
    scan of [3, 3] x [3, N] products instead of N scans."""

    def combine(f, g):
        A1, c1 = f
        A2, c2 = g
        return (
            jnp.einsum("kab,kbc->kac", A2, A1),
            jnp.einsum("kab,kbn->kan", A2, c1) + c2,
        )

    _, x = jax.lax.associative_scan(combine, (A, C), axis=0)
    return x


def _tridiag_apply_multi(Cinv, O, R):
    """Solve T X = R (R: [K, 3, N]) with the Thomas factors: forward
    substitution then back substitution, both log-depth affine scans."""
    z1 = jnp.zeros((1, 3, 3), jnp.float32)
    OtC = jnp.einsum(
        "kba,kbc->kac",
        jnp.concatenate([z1, O[:-1]]),
        jnp.concatenate([z1, Cinv[:-1]]),
    )
    y = _affine_scan(-OtC, R)
    Cy = jnp.einsum("kab,kbn->kan", Cinv, y)
    CO = jnp.einsum("kab,kbc->kac", Cinv, O)
    x_rev = _affine_scan(-CO[::-1], Cy[::-1])
    return x_rev[::-1]


def _tridiag_apply(Cinv, O, r):
    """Solve T x = r for a single [K, 3] right-hand side."""
    return _tridiag_apply_multi(Cinv, O, r[..., None])[..., 0]


def _make_matvec(g: PoseGraph, Hii, Hij, Hjj, free, damping: float,
                 psum_axis=None):
    """Matrix-free projected H V: gather V at edge endpoints, batched
    3x3 block products, segment_sum back; clamped nodes act as identity
    rows. V, HV are [K, 3] or multi-RHS [K, 3, N]."""
    K = g.poses.shape[0]
    ei, ej = g.edges_ij[:, 0], g.edges_ij[:, 1]

    def matvec(v):
        single = v.ndim == 2
        V = v[..., None] if single else v
        fm = free[:, None, None]
        vm = V * fm
        vi = vm[ei]                                  # [E, 3, N]
        vj = vm[ej]
        yi = jnp.einsum("eab,ebn->ean", Hii, vi) + jnp.einsum(
            "eab,ebn->ean", Hij, vj
        )
        yj = jnp.einsum("eba,ebn->ean", Hij, vi) + jnp.einsum(
            "eab,ebn->ean", Hjj, vj
        )
        y = _seg(yi, ei, num_segments=K) + _seg(yj, ej, num_segments=K)
        if psum_axis is not None:
            y = jax.lax.psum(y, psum_axis)
        y = (y + damping * vm) * fm
        y = y + (1.0 - fm) * V
        return y[..., 0] if single else y
    return matvec


def _loop_slots(g: PoseGraph, Lmax: int):
    """Static-capacity selection of loop (non-chain) edges: the first
    Lmax in insertion order. Returns (idx [Lmax], valid [Lmax])."""
    ei, ej = g.edges_ij[:, 0], g.edges_ij[:, 1]
    is_loop = g.edge_mask & (jnp.abs(ei - ej) != 1)
    E = ei.shape[0]
    order = jnp.argsort(
        jnp.where(is_loop, 0, 1) * (E + 1) + jnp.arange(E)
    )
    idx = order[:Lmax]
    return idx, is_loop[idx]


def _coarse_basis_apply(Kc: int, stride: int, K: int):
    """Chain-linear-interpolation coarse space: P maps [Kc, 3] coarse
    deltas to [K, 3] fine deltas with hat functions over the keyframe
    index (each of x/y/theta interpolated independently — valid in the
    LINEARIZED delta space GN solves in). Returns (prolong, restrict)."""
    kk = jnp.arange(K)
    a0 = jnp.minimum(kk // stride, Kc - 1)
    a1 = jnp.minimum(a0 + 1, Kc - 1)
    w1 = jnp.where(a1 > a0, (kk % stride) / stride, 0.0).astype(jnp.float32)
    w0 = 1.0 - w1

    def prolong(vc):                                  # [Kc, 3, N] -> [K, 3, N]
        return vc[a0] * w0[:, None, None] + vc[a1] * w1[:, None, None]

    def restrict(v):                                  # [K, 3, N] -> [Kc, 3, N]
        return _seg(v * w0[:, None, None], a0, num_segments=Kc) + _seg(
            v * w1[:, None, None], a1, num_segments=Kc
        )

    return prolong, restrict


def _make_two_level(g: PoseGraph, Cinv, O, matvec, free, Lmax: int,
                    stride: int, psum_axis=None):
    """Additive two-level preconditioner M^-1 = T^-1 + W Hc^-1 W^T.

    T^-1 (the f32 block-Thomas chain solve) is exact on LOCAL modes —
    its f32 forward error lives entirely in the global smooth modes
    (condition(T) ~ K^2) — and the coarse term covers exactly those:
    W = [P | U] spans chain-linear interpolation over `stride`-spaced
    anchors (the smooth modes, a chain of Kc anchors whose condition
    ~ Kc^2 is f32-safe) PLUS the 6 basis vectors of every loop edge's
    endpoints (deflating the <= 6L loop-coupling outlier modes that a
    chain-only preconditioner amplifies). Hc = W^T H W is dense
    [3Kc + 6Lmax]^2 — bounded by anchors + loops, NOT keyframes — and
    Cholesky-factored once per GN iteration with a small jitter (P and
    U columns can be near-dependent where a loop endpoint sits on an
    anchor; as a preconditioner the jitter is harmless, unlike the
    Woodbury capacitance this replaced, which NEEDED exact algebra and
    measured cond ~ 1e16). Both terms are SPD, so the sum is a valid CG
    preconditioner by construction."""
    K = g.poses.shape[0]
    Kc = max(2, -(-K // stride))
    idx, valid = _loop_slots(g, Lmax)
    li = g.edges_ij[idx, 0]
    lj = g.edges_ij[idx, 1]
    if psum_axis is not None:
        # the preconditioner MUST be identical on every shard (the PCG
        # vectors are replicated): rebuild the loop-slot selection from
        # the GLOBAL edge set by gathering each shard's local candidates
        # and keeping the first Lmax valid (deterministic on all shards)
        li_all = jax.lax.all_gather(li, psum_axis).reshape(-1)
        lj_all = jax.lax.all_gather(lj, psum_axis).reshape(-1)
        v_all = jax.lax.all_gather(valid, psum_axis).reshape(-1)
        M = v_all.shape[0]
        order = jnp.argsort(
            jnp.where(v_all, 0, 1) * (M + 1) + jnp.arange(M)
        )[:Lmax]
        li, lj, valid = li_all[order], lj_all[order], v_all[order]
    # the slot arrays are min(Lmax, edge capacity) long — derive every
    # size from the ACTUAL count (a graph with max_edges < Lmax
    # otherwise mismatches the tiled coord/valid arrays)
    Lmax = int(li.shape[0])
    node_of = jnp.repeat(jnp.concatenate([li, lj]), 3)    # [6L]
    coord_of = jnp.tile(jnp.arange(3), 2 * Lmax)          # [6L]
    uvalid = jnp.repeat(jnp.concatenate([valid, valid]), 3)
    prolong, restrict = _coarse_basis_apply(Kc, stride, K)

    nP = 3 * Kc
    nU = 6 * Lmax
    n = nP + nU

    def w_apply(c):                                   # [n] -> [K, 3]
        vc = c[:nP].reshape(Kc, 3)
        fine = prolong(vc[:, :, None])[..., 0]
        u = jnp.zeros((K, 3), jnp.float32).at[node_of, coord_of].add(
            c[nP:] * uvalid
        )
        return (fine + u) * free[:, None]

    def wT_apply(v):                                  # [K, 3] -> [n]
        vm = v * free[:, None]
        cP = restrict(vm[:, :, None])[..., 0].reshape(-1)
        cU = vm[node_of, coord_of] * uvalid
        return jnp.concatenate([cP, cU])

    # Hc = W^T H W: apply H to all n basis columns at once (multi-RHS
    # matvec), then restrict. Basis columns as [K, 3, n].
    eyeP = jnp.eye(nP, dtype=jnp.float32).reshape(Kc, 3, nP)
    WP = prolong(eyeP)                                # [K, 3, nP]
    WU = (
        (jnp.arange(K)[:, None, None] == node_of[None, None, :])
        & (jnp.arange(3)[None, :, None] == coord_of[None, None, :])
    ).astype(jnp.float32) * uvalid[None, None, :]
    W = jnp.concatenate([WP, WU], axis=-1) * free[:, None, None]
    HW = matvec(W)                                    # [K, 3, n]
    Hc_top = restrict(HW).reshape(nP, n)
    Hc_bot = HW[node_of, coord_of, :] * uvalid[:, None]
    Hc = jnp.concatenate([Hc_top, Hc_bot], axis=0)
    Hc = 0.5 * (Hc + Hc.T)
    jit_scale = 1e-5 * jnp.maximum(jnp.max(jnp.diag(Hc)), 1.0)
    Hc = Hc + (
        jit_scale + 1.0 * (jnp.diag(Hc) <= 0.0)
    ) * jnp.eye(n, dtype=jnp.float32)
    chol = jax.scipy.linalg.cho_factor(Hc)

    def precond(r):
        t = _tridiag_apply(Cinv, O, r)
        zc = jax.scipy.linalg.cho_solve(chol, wT_apply(r))
        return t + w_apply(zc)

    return precond


def _pcg(matvec, precond, b, iters: int):
    """Fixed-iteration preconditioned CG for H x = b, x0 = 0. A zero or
    converged residual makes every later iteration a no-op (alpha/beta
    guarded), so the fixed trip count is jit-safe."""

    def dot(a, c):
        return jnp.sum(a * c)

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)

    def body(_, carry):
        x, r, p, rz = carry
        Hp = matvec(p)
        denom = dot(p, Hp)
        alpha = jnp.where(denom > 0.0, rz / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 0.0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, r, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x, jnp.sqrt(dot(r, r))


@functools.partial(jax.jit, static_argnames=("cfg",))
def optimize_cg(g: PoseGraph, cfg: GraphConfig):
    """GN with a matrix-free two-level-preconditioned CG inner solve
    (module docstring). Drop-in for se2_graph.optimize: returns
    (graph, chi2)."""
    Lmax = cfg.sparse_max_loops

    def gn_body(it, carry):
        poses, _ = carry
        robust = _robust_of(cfg, it)
        D, O, b, chi, free, (Hii, Hij, Hjj) = _assemble_sparse(
            poses, g, robust, cfg.damping
        )
        Cinv = _tridiag_factor(D, O)
        matvec = _make_matvec(g, Hii, Hij, Hjj, free, cfg.damping)
        precond = _make_two_level(
            g, Cinv, O, matvec, free, Lmax, cfg.sparse_coarse_stride
        )
        delta, _res = _pcg(matvec, precond, -b, cfg.sparse_cg_iters)
        new = poses + delta * free[:, None]
        new = new.at[:, 2].set(se2.wrap_angle(new[:, 2]))
        return new, chi

    with jax.default_matmul_precision("highest"):
        poses, chi = jax.lax.fori_loop(
            0, cfg.gn_iters, gn_body, (g.poses, jnp.float32(0.0))
        )
    return g._replace(poses=poses), chi


def _segmented_compose(z_chain, K: int, stride: int):
    """R_k = z_{a} ⊕ ... ⊕ z_{k-1} for a = anchor(k) = stride*(k//stride)
    (identity at anchors), via a segmented associative scan over SE(2)
    composition — elements (pose, reset) with
    combine((p1, r1), (p2, r2)) = (p2 if r2 else p1 ⊕ p2, r1 | r2).

    z_chain: [K, 3] with z_chain[k] the measured delta k -> k+1 (only
    rows 0..K-2 read). Returns R [K, 3]."""
    idx = jnp.arange(K)
    reset = (idx % stride == 0) | (idx == 0)
    z_prev = jnp.concatenate([jnp.zeros((1, 3), jnp.float32), z_chain[:-1]])
    elems = (jnp.where(reset[:, None], 0.0, z_prev), reset)

    def combine(e1, e2):
        p1, r1 = e1
        p2, r2 = e2
        return (
            jnp.where(r2[..., None], p2, se2.compose(p1, p2)),
            r1 | r2,
        )

    R, _ = jax.lax.associative_scan(combine, elems, axis=0)
    return R


def _coarse_graph(g: PoseGraph, cfg: GraphConfig, stride: int,
                  Lmax: int):
    """Anchor-subsampled pose graph: every `stride`-th node, chain edges
    carrying the COMPOSED odometry measurements between anchors
    (information scaled 1/stride — composition-grade, the coarse solve
    is an initializer), loop edges re-anchored with the measured
    intra-segment transforms. Returns (coarse PoseGraph, coarse cfg)."""
    import dataclasses

    K = g.poses.shape[0]
    Kc = max(2, -(-K // stride))

    # chain measurement per position: z_chain[k] = z of edge (k, k+1)
    ei, ej = g.edges_ij[:, 0], g.edges_ij[:, 1]
    chain_f = (ej == ei + 1) & g.edge_mask
    chain_r = (ei == ej + 1) & g.edge_mask
    zf = jnp.where(chain_f[:, None], g.edges_z, 0.0)
    zr = jax.vmap(se2.inverse)(g.edges_z)
    zr = jnp.where(chain_r[:, None], zr, 0.0)
    z_chain = _seg(zf, ei, num_segments=K) + _seg(
        zr, ej, num_segments=K
    )
    have = (
        _seg(chain_f.astype(jnp.float32), ei, num_segments=K)
        + _seg(chain_r.astype(jnp.float32), ej, num_segments=K)
    )
    z_chain = z_chain / jnp.maximum(have[:, None], 1.0)  # duplicate mean
    R = _segmented_compose(z_chain, K, stride)           # anchor -> k

    anchors = jnp.minimum(jnp.arange(Kc) * stride, K - 1)
    # coarse chain z: anchor c -> anchor c+1 = R[last in segment] ⊕ z[last]
    last = jnp.minimum((jnp.arange(Kc - 1) + 1) * stride - 1, K - 2)
    zc_chain = se2.compose(R[last], z_chain[last])
    cij = jnp.stack(
        [jnp.arange(Kc - 1), jnp.arange(1, Kc)], axis=1
    ).astype(jnp.int32)
    # mean chain omega, scaled by 1/stride (random-walk composition)
    om_mean = jnp.sum(
        g.edges_omega * chain_f[:, None, None], axis=0
    ) / jnp.maximum(jnp.sum(chain_f.astype(jnp.float32)), 1.0)
    omc_chain = jnp.broadcast_to(
        om_mean / stride, (Kc - 1, 3, 3)
    )

    # loop edges -> anchor pairs with re-anchored measurements
    idx, valid = _loop_slots(g, Lmax)
    # _loop_slots clamps to the graph's edge capacity when E < Lmax —
    # size Ec from the slots actually returned so n_edges/max_edges
    # match the concatenated arrays (mirrors the _make_two_level fix)
    Lmax = int(idx.shape[0])
    Ec = (Kc - 1) + Lmax
    li, lj = g.edges_ij[idx, 0], g.edges_ij[idx, 1]
    ca = (li // stride).astype(jnp.int32)
    cb = (lj // stride).astype(jnp.int32)
    z_l = se2.compose(
        se2.compose(R[li], g.edges_z[idx]),
        jax.vmap(se2.inverse)(R[lj]),
    )
    # an intra-segment "loop" collapses to a self-edge: mask it out
    valid = valid & (ca != cb)
    lij = jnp.stack([ca, cb], axis=1)
    om_l = g.edges_omega[idx]

    # active coarse nodes = ceil(n_nodes / stride); chain edges connect
    # consecutive ACTIVE anchors only — `n_nodes // stride` was an
    # off-by-one whenever stride | n_nodes with spare capacity: it
    # activated an edge from the last real anchor to an inactive
    # zero-pose anchor and corrupted the coarse solve (round-4 review)
    nc = jnp.minimum((g.n_nodes + stride - 1) // stride, Kc)
    gc = PoseGraph(
        poses=g.poses[anchors],
        node_mask=g.node_mask[anchors],
        n_nodes=nc,
        edges_ij=jnp.concatenate([cij, lij]),
        edges_z=jnp.concatenate([zc_chain, z_l]),
        edges_omega=jnp.concatenate([omc_chain, om_l]),
        edge_mask=jnp.concatenate(
            [jnp.arange(Kc - 1) < nc - 1, valid]
        ),
        n_edges=jnp.int32(Ec),
    )
    ccfg = dataclasses.replace(
        cfg, max_nodes=Kc, max_edges=Ec
    )
    return gc, ccfg, anchors


@functools.partial(jax.jit, static_argnames=("cfg",))
def optimize_hier(g: PoseGraph, cfg: GraphConfig):
    """Hierarchical GN for large graphs: dense GN on the
    stride-subsampled anchor graph (global/low modes — the chain of
    K/stride anchors is short enough that f32 dense Cholesky is
    accurate), rigid prolongation of the anchor corrections onto the
    intra-segment nodes, then `optimize_cg`'s two-level PCG as the fine
    polish (local modes).

    Why not one flat solve: at K ~ 4096 the chain condition (~K^2 *
    info-ratio ~ 1e7) puts f32 residual noise over the lowest modes at
    O(1) meters — measured: flat PCG stalls at err ~ 1.4 where this
    two-stage form matches the f64 answer to centimeters. This is the
    static-shape analog of hierarchical/submap pose-graph SLAM.
    """
    from slam2d_tpu.graph.se2_graph import optimize as optimize_dense

    stride = cfg.sparse_coarse_stride
    dense_max = int(getattr(cfg, "hier_dense_max", 1024))
    cycles = max(1, int(getattr(cfg, "sparse_hier_cycles", 1)))

    def vcycle(g_l: PoseGraph, cfg_l: GraphConfig, top: bool):
        """Recursive V-cycle (round 5): coarsen until the anchor chain is
        small enough for an ACCURATE f32 dense Cholesky (<= hier_dense_max
        nodes — the measured f32 collapse boundary is ~1-2k, and the
        coarse chain's information shrinks by 1/stride per level, so the
        threshold IS the condition-driven stride selection: total
        coarsening factor stride^depth adapts to K with no manual
        tuning), then prolong straight down and PCG-polish ONLY at the
        original level. Intermediate-level PCG polish measured DIVERGENT
        (chi ~2e8 at the 1024-node coarse of K=16384): coarse chain
        edges carry ~stride-meter translations, so a heading error moves
        the next anchor by stride*theta — the GN linearization overshoots
        at that nonlinearity. The deeper levels' loop structure still
        enters through the recursive coarse solves' re-anchored loop
        edges. Shapes are static per level, so the Python recursion
        traces once."""
        K_l = g_l.poses.shape[0]
        if K_l <= dense_max:
            g2, chi = optimize_dense(g_l, cfg_l)
            return g2, chi
        gc, ccfg, anchors = _coarse_graph(
            g_l, cfg_l, stride, cfg_l.sparse_max_loops
        )
        gc2, _chi_c = vcycle(gc, ccfg, top=False)
        # prolong: left-transform each segment rigidly with its anchor's
        # correction corr_c = X'_a ⊕ X_a^-1
        corr = jax.vmap(
            lambda new, old: se2.compose(new, se2.inverse(old))
        )(gc2.poses, g_l.poses[anchors])
        seg_of = jnp.minimum(
            jnp.arange(K_l) // stride, corr.shape[0] - 1
        )
        poses1 = jax.vmap(se2.compose)(corr[seg_of], g_l.poses)
        g1 = g_l._replace(poses=poses1)
        if not top:
            return g1, _chi_c
        return optimize_cg(g1, cfg_l)

    out, chi = vcycle(g, cfg, top=True)
    for _ in range(cycles - 1):
        # extra V-cycles re-coarsen from the improved iterate: the coarse
        # measurements re-anchor on the current poses, so global modes
        # that the first cycle's f32 coarse solve left behind get a
        # second pass (sparse_hier_cycles; measured in bench_hier_floor)
        out, chi = vcycle(out, cfg, top=True)
    return out, chi


def optimize_cg_sharded(g: PoseGraph, cfg: GraphConfig, mesh,
                        axis: str = "particles"):
    """Edge-sharded distributed form of `optimize_cg` (SURVEY §4.4
    "distributed reduction", extended to the matrix-free solver family):
    the EDGE set splits over the mesh, each shard assembles (D, O, b)
    and applies H from its local slice, and psum reduces across devices —
    the [K]-sized node quantities and the preconditioner factor stay
    replicated (they are bounded by keyframes, not edges, and the PCG
    vectors must be identical on every shard anyway).

    Returns (graph, chi2), numerically ~= optimize_cg (the psum changes
    the f32 reduction order of the edge sums)."""
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape[axis]
    E = g.edges_ij.shape[0]
    pad = (-E) % n_shards
    orig = g  # return the caller's fixed edge capacity, not the padded copy
    if pad:
        g = g._replace(
            edges_ij=jnp.concatenate(
                [g.edges_ij, jnp.zeros((pad, 2), jnp.int32)]
            ),
            edges_z=jnp.concatenate(
                [g.edges_z, jnp.zeros((pad, 3), jnp.float32)]
            ),
            edges_omega=jnp.concatenate(
                [g.edges_omega, jnp.zeros((pad, 3, 3), jnp.float32)]
            ),
            edge_mask=jnp.concatenate(
                [g.edge_mask, jnp.zeros(pad, bool)]
            ),
        )
    Lmax = cfg.sparse_max_loops

    def gn(poses, node_mask, n_nodes, edges_ij, edges_z, edges_omega,
           edge_mask):
        g_l = PoseGraph(
            poses, node_mask, n_nodes, edges_ij, edges_z, edges_omega,
            edge_mask, jnp.int32(edges_ij.shape[0]),
        )

        def gn_body(it, carry):
            p, _ = carry
            g_it = g_l._replace(poses=p)
            robust = _robust_of(cfg, it)
            D, O, b, chi, free, (Hii, Hij, Hjj) = _assemble_sparse(
                p, g_it, robust, cfg.damping, psum_axis=axis
            )
            Cinv = _tridiag_factor(D, O)
            matvec = _make_matvec(
                g_it, Hii, Hij, Hjj, free, cfg.damping, psum_axis=axis
            )
            # psum_axis makes the preconditioner shard-invariant: the
            # loop-slot selection all_gathers the shard-local candidates
            # and every shard keeps the same first-Lmax-valid set
            precond = _make_two_level(
                g_it, Cinv, O, matvec, free, Lmax,
                cfg.sparse_coarse_stride, psum_axis=axis
            )
            delta, _res = _pcg(matvec, precond, -b, cfg.sparse_cg_iters)
            new = p + delta * free[:, None]
            new = new.at[:, 2].set(se2.wrap_angle(new[:, 2]))
            return new, chi

        with jax.default_matmul_precision("highest"):
            poses_out, chi = jax.lax.fori_loop(
                0, cfg.gn_iters, gn_body, (poses, jnp.float32(0.0))
            )
        return poses_out, chi

    sharded = jax.shard_map(
        gn,
        mesh=mesh,
        in_specs=(P(None), P(None), P(), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=(P(None), P()),
        check_vma=False,
    )
    poses, chi = jax.jit(sharded)(
        g.poses, g.node_mask, g.n_nodes, g.edges_ij, g.edges_z,
        g.edges_omega, g.edge_mask,
    )
    return orig._replace(poses=poses), chi
