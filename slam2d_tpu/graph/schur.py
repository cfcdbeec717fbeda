"""Block Schur-complement pose-graph solver (SURVEY.md §4.4 distributed form).

Nodes are partitioned into contiguous keyframe blocks. Every edge that
crosses a block boundary makes both its endpoints SEPARATOR variables; all
other nodes are block-INTERIOR. Then, exactly:

    H = [ H_bb (block-diag)   H_bs ]
        [ H_sb                H_ss ]

and one Gauss-Newton step factors as

  per block (parallel / shardable):   eliminate interiors
      S_b   = - H_sb H_bb^-1 H_bs          (Schur contribution)
      rhs_b = - H_sb H_bb^-1 b_b
  reduce (psum over the block axis):  S = H_ss + sum_b S_b, r = b_s + sum_b rhs_b
  replicated:                         solve S * ds = -r  (small separator system)
  per block:                          back-substitute db = H_bb^-1 (-b_b - H_bs ds)

The partition/classification is HOST-side (the edge list lives on the host
anyway); the device sees static padded index arrays. `optimize_schur` runs
the blocks as a vmapped batch on one device; `make_optimize_schur_sharded`
shards the block axis over the mesh with the reduction as an actual psum —
the collective schedule a multi-device run executes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.core import se2
from slam2d_tpu.graph.se2_graph import PoseGraph, _edge_blocks


class SchurPlan(NamedTuple):
    """Host-built static-shape partition plan (all numpy, trace constants)."""

    sep_ids: np.ndarray       # [S] global node ids of separators (padded -1)
    n_sep: int
    # per block b:
    int_ids: np.ndarray       # [NB, I] interior global node ids (padded -1)
    edge_idx: np.ndarray      # [NB, E_b] edge indices assigned to the block
    edge_mask: np.ndarray     # [NB, E_b]
    # per assigned edge: endpoint-local addressing
    ei_slot: np.ndarray       # [NB, E_b] local slot of endpoint i
    ei_is_sep: np.ndarray     # [NB, E_b] bool: slot indexes separators
    ej_slot: np.ndarray       # [NB, E_b]
    ej_is_sep: np.ndarray     # [NB, E_b]


def build_plan(g: PoseGraph, n_blocks: int) -> SchurPlan:
    """Partition active nodes into contiguous blocks; classify separators."""
    K = int(g.n_nodes)
    E = int(g.n_edges)
    if K == 0 or E == 0:
        raise ValueError(
            f"Schur plan needs a non-empty graph (nodes={K}, edges={E}); "
            "callers should return the graph unchanged instead"
        )
    ij = np.asarray(g.edges_ij[:E])
    blk_size = max(1, -(-K // n_blocks))
    block_of = np.minimum(np.arange(K) // blk_size, n_blocks - 1)

    cross = block_of[ij[:, 0]] != block_of[ij[:, 1]]
    is_sep = np.zeros(K, bool)
    is_sep[ij[cross].reshape(-1)] = True
    is_sep[0] = True  # the anchor joins the (replicated) separator system

    sep_ids = np.flatnonzero(is_sep)
    S = len(sep_ids)
    sep_slot = np.full(K, -1, np.int64)
    sep_slot[sep_ids] = np.arange(S)

    int_lists, edge_lists = [], []
    int_slot = np.full(K, -1, np.int64)
    for b in range(n_blocks):
        ids = np.flatnonzero((block_of == b) & ~is_sep)
        int_slot[ids] = np.arange(len(ids))
        int_lists.append(ids)
        # edge assigned to block of its min endpoint (cross edges too —
        # their H_ss contribution gets summed exactly once)
        eb = np.flatnonzero(
            np.minimum(block_of[ij[:, 0]], block_of[ij[:, 1]]) == b
        )
        edge_lists.append(eb)

    I = max((len(x) for x in int_lists), default=1) or 1
    Eb = max((len(x) for x in edge_lists), default=1) or 1

    def pad(lists, width, fill):
        out = np.full((n_blocks, width), fill, np.int64)
        for b, lst in enumerate(lists):
            out[b, : len(lst)] = lst
        return out

    int_ids = pad(int_lists, I, -1)
    edge_idx = pad(edge_lists, Eb, 0)
    edge_mask = np.zeros((n_blocks, Eb), bool)
    for b, lst in enumerate(edge_lists):
        edge_mask[b, : len(lst)] = True

    ei = ij[edge_idx.reshape(-1), 0].reshape(n_blocks, Eb)
    ej = ij[edge_idx.reshape(-1), 1].reshape(n_blocks, Eb)
    ei_is_sep = is_sep[ei]
    ej_is_sep = is_sep[ej]
    ei_slot = np.where(ei_is_sep, sep_slot[ei], int_slot[ei])
    ej_slot = np.where(ej_is_sep, sep_slot[ej], int_slot[ej])

    return SchurPlan(
        sep_ids=sep_ids, n_sep=S,
        int_ids=int_ids,
        edge_idx=edge_idx, edge_mask=edge_mask,
        ei_slot=ei_slot, ei_is_sep=ei_is_sep,
        ej_slot=ej_slot, ej_is_sep=ej_is_sep,
    )


def _block_assemble(poses, g: PoseGraph, plan_b, I: int, S: int,
                    robust: tuple[str, float] | None = None):
    """Assemble one block's (Hbb, Hbs, Hss_contrib, bb, bs_contrib, chi)."""
    edge_idx, edge_mask, ei_slot, ei_sep, ej_slot, ej_sep = plan_b
    ij = g.edges_ij[edge_idx]
    z = g.edges_z[edge_idx]
    om = g.edges_omega[edge_idx]
    m = edge_mask & g.edge_mask[edge_idx]
    Hii, Hij, Hjj, bi, bj, chi = _edge_blocks(
        poses, ij, z, om, m, robust
    )

    nI, nS = 3 * I, 3 * S
    Hbb = jnp.zeros((nI, nI), jnp.float32)
    Hbs = jnp.zeros((nI, nS), jnp.float32)
    Hss = jnp.zeros((nS, nS), jnp.float32)
    bb = jnp.zeros((nI,), jnp.float32)
    bs = jnp.zeros((nS,), jnp.float32)

    off = jnp.arange(3)

    def rows(slot):
        return (3 * slot)[:, None] + off[None, :]     # [E, 3]

    ri, rj = rows(ei_slot), rows(ej_slot)

    def scat(H, r, c, blk, mask):
        blk = blk * mask[:, None, None]
        return H.at[r[:, :, None], c[:, None, :]].add(blk)

    def scatv(v, r, blk, mask):
        return v.at[r].add(blk * mask[:, None])

    mi_int = (~ei_sep) & m
    mi_sep = ei_sep & m
    mj_int = (~ej_sep) & m
    mj_sep = ej_sep & m

    # diagonal blocks
    Hbb = scat(Hbb, ri, ri, Hii, mi_int.astype(jnp.float32))
    Hss = scat(Hss, ri, ri, Hii, mi_sep.astype(jnp.float32))
    Hbb = scat(Hbb, rj, rj, Hjj, mj_int.astype(jnp.float32))
    Hss = scat(Hss, rj, rj, Hjj, mj_sep.astype(jnp.float32))
    # off-diagonal i-j
    HijT = jnp.swapaxes(Hij, 1, 2)
    Hbb = scat(Hbb, ri, rj, Hij, (mi_int & mj_int).astype(jnp.float32))
    Hbb = scat(Hbb, rj, ri, HijT, (mi_int & mj_int).astype(jnp.float32))
    Hbs = scat(Hbs, ri, rj, Hij, (mi_int & mj_sep).astype(jnp.float32))
    Hbs = scat(Hbs, rj, ri, HijT, (mi_sep & mj_int).astype(jnp.float32))
    Hss = scat(Hss, ri, rj, Hij, (mi_sep & mj_sep).astype(jnp.float32))
    Hss = scat(Hss, rj, ri, HijT, (mi_sep & mj_sep).astype(jnp.float32))
    # rhs
    bb = scatv(bb, ri, bi, mi_int.astype(jnp.float32))
    bs = scatv(bs, ri, bi, mi_sep.astype(jnp.float32))
    bb = scatv(bb, rj, bj, mj_int.astype(jnp.float32))
    bs = scatv(bs, rj, bj, mj_sep.astype(jnp.float32))

    return Hbb, Hbs, Hss, bb, bs, jnp.sum(chi)


def _plan_device_arrays(plan: SchurPlan):
    """(plan_dev [NB, ...] tuple, int_ids, int_valid, sep_ids) as jnp."""
    plan_dev = (
        jnp.asarray(plan.edge_idx), jnp.asarray(plan.edge_mask),
        jnp.asarray(np.where(plan.ei_slot < 0, 0, plan.ei_slot)),
        jnp.asarray(plan.ei_is_sep),
        jnp.asarray(np.where(plan.ej_slot < 0, 0, plan.ej_slot)),
        jnp.asarray(plan.ej_is_sep),
    )
    int_ids = jnp.asarray(np.where(plan.int_ids < 0, 0, plan.int_ids))
    int_valid = jnp.asarray(plan.int_ids >= 0)
    sep_ids = jnp.asarray(plan.sep_ids)
    return plan_dev, int_ids, int_valid, sep_ids


def _host_delta_eff(cfg: GraphConfig, it: int) -> float:
    """Effective robust threshold for GN iteration `it` (GNC annealing;
    see se2_graph._robust_of). Host-side mirror for the Schur solvers,
    whose GN loop lives on the host."""
    if cfg.robust_kind == "none":
        return 0.0
    return cfg.robust_delta * 10.0 ** max(0, cfg.robust_gnc_iters - it)


def _iteration_core(
    poses, g, plan_dev, int_ids, int_valid, sep_ids,
    I: int, S: int, cfg: GraphConfig, psum_axis=None, robust_delta_eff=None,
):
    """One GN iteration over a (possibly shard-local) batch of blocks.

    Returns (new_poses [K, 3] — includes the global separator update plus
    THIS shard's interior updates combined via psum when psum_axis is set —
    and the total chi^2).

    Runs entirely at full-f32 matmul precision: reduced-precision
    matmuls (bf16 operands, or TF32 — a GPU's default for f32) perturb
    the J^T Omega J products and the Schur complement enough to make the
    near-singular pose-graph systems indefinite, and Cholesky then NaNs
    (see se2_graph._edge_blocks)."""
    with jax.default_matmul_precision("highest"):
        return _iteration_core_f32(
            poses, g, plan_dev, int_ids, int_valid, sep_ids, I, S, cfg,
            psum_axis, robust_delta_eff,
        )


def _iteration_core_f32(
    poses, g, plan_dev, int_ids, int_valid, sep_ids,
    I: int, S: int, cfg: GraphConfig, psum_axis=None, robust_delta_eff=None,
):
    robust = (
        None if cfg.robust_kind == "none"
        else (cfg.robust_kind, robust_delta_eff)
    )

    def per_block(plan_b, valid_b):
        Hbb, Hbs, Hss_c, bb, bs_c, chi = _block_assemble(
            poses, g, plan_b, I, S, robust
        )
        # damping + identity on padded interior slots keeps Hbb invertible
        pad = jnp.repeat(~valid_b, 3).astype(jnp.float32)
        Hbb = 0.5 * (Hbb + Hbb.T) + jnp.diag(pad + cfg.damping)
        c, _ = jax.scipy.linalg.cho_factor(Hbb)
        HinvB = jax.scipy.linalg.cho_solve((c, False), Hbs)  # Hbb^-1 Hbs
        Hinvb = jax.scipy.linalg.cho_solve((c, False), bb)   # Hbb^-1 bb
        S_c = Hss_c - Hbs.T @ HinvB
        r_c = bs_c - Hbs.T @ Hinvb
        return S_c, r_c, chi, (c, Hbs, bb)

    S_cs, r_cs, chis, backsub = jax.vmap(per_block)(plan_dev, int_valid)

    S_tot = jnp.sum(S_cs, axis=0)
    r_tot = jnp.sum(r_cs, axis=0)
    chi = jnp.sum(chis)
    if psum_axis is not None:
        S_tot = jax.lax.psum(S_tot, psum_axis)
        r_tot = jax.lax.psum(r_tot, psum_axis)
        chi = jax.lax.psum(chi, psum_axis)

    # anchor: node 0 is always a separator; pin its slot
    anchor_slot = jnp.argmax((sep_ids == 0).astype(jnp.int32))
    diag = jnp.zeros(3 * S).at[
        3 * anchor_slot + jnp.arange(3)
    ].set(1e8) + cfg.damping
    S_tot = 0.5 * (S_tot + S_tot.T) + jnp.diag(diag)
    ds = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S_tot), -r_tot
    )                                                       # [3S]

    # back-substitute interiors per block
    def back(blk, valid_b):
        c, Hbs, bb = blk
        db = jax.scipy.linalg.cho_solve((c, False), -bb - Hbs @ ds)
        return db.reshape(I, 3) * valid_b[:, None]

    dbs = jax.vmap(back)(backsub, int_valid)                # [NB_local, I, 3]

    # interior deltas are local to this shard's blocks; the separator delta
    # is replicated — psum only the interior part
    flat_ids = int_ids.reshape(-1)
    flat_db = dbs.reshape(-1, 3) * int_valid.reshape(-1)[:, None]
    delta = jnp.zeros_like(poses).at[flat_ids].add(flat_db)
    if psum_axis is not None:
        delta = jax.lax.psum(delta, psum_axis)
    delta = delta.at[sep_ids].add(ds.reshape(S, 3))
    new = poses + delta
    new = new.at[:, 2].set(se2.wrap_angle(new[:, 2]))
    return new, chi


import functools


@functools.partial(jax.jit, static_argnames=("I", "S", "cfg"))
def _jit_iteration(poses, g, plan_dev, int_ids, int_valid, sep_ids, I, S, cfg,
                   robust_delta_eff):
    return _iteration_core(
        poses, g, plan_dev, int_ids, int_valid, sep_ids, I, S, cfg,
        robust_delta_eff=robust_delta_eff,
    )


def optimize_schur(g: PoseGraph, cfg: GraphConfig, n_blocks: int = 4):
    """GN via block Schur elimination on one device (vmapped blocks)."""
    if int(g.n_nodes) == 0 or int(g.n_edges) == 0:
        return g, jnp.float32(0.0)
    plan = build_plan(g, n_blocks)
    plan_dev, int_ids, int_valid, sep_ids = _plan_device_arrays(plan)
    I = plan.int_ids.shape[1]
    poses = g.poses
    chi = jnp.float32(0.0)
    for it in range(cfg.gn_iters):
        poses, chi = _jit_iteration(
            poses, g, plan_dev, int_ids, int_valid, sep_ids,
            I, plan.n_sep, cfg, jnp.float32(_host_delta_eff(cfg, it)),
        )
    return g._replace(poses=poses), chi


@functools.lru_cache(maxsize=32)
def _make_sharded_iter(cfg: GraphConfig, mesh, axis: str, I: int, S: int):
    """Cached shard_map program — caching by the STATIC dims keeps jax.jit's
    trace cache effective across calls (fresh closures would recompile)."""
    from jax.sharding import PartitionSpec as P

    def one_iter(poses, plan_dev, int_ids, int_valid, sep_ids,
                 edges_ij, edges_z, edges_omega, edge_mask,
                 robust_delta_eff):
        K = poses.shape[0]
        gg = PoseGraph(
            poses=poses,
            node_mask=jnp.zeros(K, bool),
            n_nodes=jnp.int32(0),
            edges_ij=edges_ij, edges_z=edges_z,
            edges_omega=edges_omega, edge_mask=edge_mask,
            n_edges=jnp.int32(0),
        )
        return _iteration_core(
            poses, gg, plan_dev, int_ids, int_valid, sep_ids,
            I, S, cfg, psum_axis=axis, robust_delta_eff=robust_delta_eff,
        )

    blocked = P(axis)
    repl = P(None)
    return jax.jit(
        jax.shard_map(
            one_iter,
            mesh=mesh,
            in_specs=(
                repl,
                (blocked,) * 6,   # plan arrays: [NB, ...] block-sharded
                blocked, blocked, repl,
                repl, repl, repl, repl,
                P(),   # scalar robust threshold, replicated
            ),
            out_specs=(repl, P()),
            check_vma=False,
        )
    )


def optimize_schur_sharded(
    g: PoseGraph, cfg: GraphConfig, mesh, n_blocks: int | None = None,
    axis: str = "particles",
):
    """Schur elimination with the BLOCK axis sharded over the mesh: each
    shard eliminates its keyframe blocks, the reduced separator system is
    psum-reduced across devices and solved replicated (SURVEY.md §4.4)."""
    if int(g.n_nodes) == 0 or int(g.n_edges) == 0:
        return g, jnp.float32(0.0)
    n_shards = mesh.shape[axis]
    n_blocks = n_blocks or n_shards
    assert n_blocks % n_shards == 0, (n_blocks, n_shards)
    plan = build_plan(g, n_blocks)
    plan_dev, int_ids, int_valid, sep_ids = _plan_device_arrays(plan)
    I = plan.int_ids.shape[1]
    S = plan.n_sep
    sharded_iter = _make_sharded_iter(cfg, mesh, axis, I, S)

    poses = g.poses
    chi = jnp.float32(0.0)
    for it in range(cfg.gn_iters):
        poses, chi = sharded_iter(
            poses, plan_dev, int_ids, int_valid, sep_ids,
            g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask,
            jnp.float32(_host_delta_eff(cfg, it)),
        )
    return g._replace(poses=poses), chi
