"""SE(2) pose-graph backend: Gauss-Newton with loop closure (SURVEY.md §4.4).

The reference (per BASELINE) optimizes e_ij = t2v(Z_ij^-1 (Xi^-1 Xj)) with
Gauss-Newton over a Python edge list. Static-shape formulation:

- static capacity: node/edge arrays are fixed-size ([Kmax, 3], [Emax, ...])
  with validity masks, so the whole optimizer jits once regardless of how
  many keyframes exist yet;
- per-edge 3x3 Jacobians come from `jax.jacfwd` of the residual (exact,
  vmapped over the edge axis — no hand-derived formulas to get wrong);
- H and b assemble with one scatter-add of [E, 3, 3] blocks into the dense
  [3K, 3K] normal matrix (K <= a few hundred keyframes: a dense Cholesky
  beats sparse bookkeeping);
- node 0 anchors via a large prior block; Levenberg damping on the diagonal;
- `gn_iters` fixed iterations inside a `lax.fori_loop` (static trip count).

Distributed form: `optimize_sharded` shards the EDGE set over the mesh,
psums the assembled (H, b) across devices and solves the (small)
dense system replicated. Keyframe-block Schur elimination (SURVEY.md §4.4
distributed form) is the planned refinement once node counts warrant it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.core import se2


class PoseGraph(NamedTuple):
    poses: jax.Array        # [K, 3] current node estimates
    node_mask: jax.Array    # [K] bool: node slot in use
    n_nodes: jax.Array      # scalar int32
    edges_ij: jax.Array     # [E, 2] int32 (i, j) node indices
    edges_z: jax.Array      # [E, 3] measured relative pose i -> j
    edges_omega: jax.Array  # [E, 3, 3] information matrices
    edge_mask: jax.Array    # [E] bool
    n_edges: jax.Array      # scalar int32


def graph_init(cfg: GraphConfig) -> PoseGraph:
    K, E = cfg.max_nodes, cfg.max_edges
    return PoseGraph(
        poses=jnp.zeros((K, 3), jnp.float32),
        node_mask=jnp.zeros(K, bool),
        n_nodes=jnp.int32(0),
        edges_ij=jnp.zeros((E, 2), jnp.int32),
        edges_z=jnp.zeros((E, 3), jnp.float32),
        edges_omega=jnp.zeros((E, 3, 3), jnp.float32),
        edge_mask=jnp.zeros(E, bool),
        n_edges=jnp.int32(0),
    )


class HostGraph:
    """Host-side graph builder mirroring PoseGraph's layout in numpy.

    Keyframe admission is a host event: building the graph with eager
    device `.at[].set` updates costs several eager dispatches per
    keyframe, pure dispatch latency. Nodes/edges accumulate in numpy;
    `to_device()` materializes a PoseGraph with ONE transfer when an
    optimizer runs."""

    def __init__(self, cfg: GraphConfig):
        import numpy as np

        K, E = cfg.max_nodes, cfg.max_edges
        self.poses = np.zeros((K, 3), np.float32)
        self.node_mask = np.zeros(K, bool)
        self.n_nodes = 0
        self.edges_ij = np.zeros((E, 2), np.int32)
        self.edges_z = np.zeros((E, 3), np.float32)
        self.edges_omega = np.zeros((E, 3, 3), np.float32)
        self.edge_mask = np.zeros(E, bool)
        self.n_edges = 0

    @classmethod
    def from_arrays(cls, cfg: GraphConfig, g) -> "HostGraph":
        """Restore from a checkpointed PoseGraph-shaped tree (np or jnp)."""
        import numpy as np

        self = cls(cfg)
        self.poses = np.array(g.poses, np.float32)
        self.node_mask = np.array(g.node_mask, bool)
        self.n_nodes = int(g.n_nodes)
        self.edges_ij = np.array(g.edges_ij, np.int32)
        self.edges_z = np.array(g.edges_z, np.float32)
        self.edges_omega = np.array(g.edges_omega, np.float32)
        self.edge_mask = np.array(g.edge_mask, bool)
        self.n_edges = int(g.n_edges)
        return self

    def add_node(self, pose) -> int:
        import numpy as np

        k = self.n_nodes
        self.poses[k] = np.asarray(pose, np.float32)
        self.node_mask[k] = True
        self.n_nodes = k + 1
        return k

    def add_edge(self, i: int, j: int, z, omega) -> int:
        import numpy as np

        e = self.n_edges
        self.edges_ij[e] = (i, j)
        self.edges_z[e] = np.asarray(z, np.float32)
        self.edges_omega[e] = np.asarray(omega, np.float32)
        self.edge_mask[e] = True
        self.n_edges = e + 1
        return e

    def to_device(self) -> PoseGraph:
        return PoseGraph(
            poses=jnp.asarray(self.poses),
            node_mask=jnp.asarray(self.node_mask),
            n_nodes=jnp.int32(self.n_nodes),
            edges_ij=jnp.asarray(self.edges_ij),
            edges_z=jnp.asarray(self.edges_z),
            edges_omega=jnp.asarray(self.edges_omega),
            edge_mask=jnp.asarray(self.edge_mask),
            n_edges=jnp.int32(self.n_edges),
        )

    def set_poses(self, poses) -> None:
        """Write back optimizer-corrected node estimates (host copy)."""
        import numpy as np

        n = len(poses)
        self.poses[:n] = np.asarray(poses, np.float32)


def add_node(g: PoseGraph, pose) -> PoseGraph:
    k = g.n_nodes
    return g._replace(
        poses=g.poses.at[k].set(pose),
        node_mask=g.node_mask.at[k].set(True),
        n_nodes=k + 1,
    )


def add_edge(g: PoseGraph, i, j, z, omega) -> PoseGraph:
    e = g.n_edges
    return g._replace(
        edges_ij=g.edges_ij.at[e].set(jnp.stack([i, j]).astype(jnp.int32)),
        edges_z=g.edges_z.at[e].set(z),
        edges_omega=g.edges_omega.at[e].set(omega),
        edge_mask=g.edge_mask.at[e].set(True),
        n_edges=e + 1,
    )


def edge_residuals(poses, edges_ij, edges_z):
    """Vmapped e_ij = t2v(Z^-1 (Xi^-1 Xj)); returns [E, 3]."""
    xi = poses[edges_ij[:, 0]]
    xj = poses[edges_ij[:, 1]]
    return jax.vmap(se2.error_se2)(xi, xj, edges_z)


def _robust_weight(chi, kind: str, delta: float):
    """IRLS weight + robustified cost for one edge given chi2 = e^T Omega e.

    kind="huber": w = min(1, delta/||e||), rho = delta*(2||e|| - delta)
    past the threshold — constant influence, safe for cold starts.
    kind="dcs": Dynamic Covariance Scaling (Agarwal et al., ICRA 2013)
    with Phi = delta^2: s = min(1, 2 Phi/(Phi + chi2)), weight s^2,
    rho = s^2 chi2 + (1-s)^2 Phi... we report s*chi (the DCS paper's
    scaled cost) so traces stay monotone-comparable. Redescending: gross
    outliers' influence -> 0."""
    if kind == "huber":
        norm = jnp.sqrt(jnp.maximum(chi, 1e-12))
        w = jnp.minimum(1.0, delta / norm)
        rho = jnp.where(norm <= delta, chi, delta * (2.0 * norm - delta))
        return w, rho
    if kind == "dcs":
        phi = delta * delta
        s = jnp.minimum(1.0, 2.0 * phi / (phi + chi))
        return s * s, s * chi
    raise ValueError(f"unknown robust_kind {kind!r}")


def _edge_blocks(poses, edges_ij, edges_z, edges_omega, edge_mask,
                 robust: tuple[str, float] | None = None):
    """Per-edge H/b blocks. Returns (Hii, Hij, Hjj, bi, bj, err) stacked [E, ...].

    `robust=(kind, delta)` enables a robust kernel via IRLS: each edge's
    information matrix is scaled by a weight of its whitened residual norm
    ||e||_Omega = sqrt(e^T Omega e) (see _robust_weight). Inlier edges keep
    full weight; a grossly inconsistent edge — e.g. a false-positive loop
    closure that survived the accept gates — fails SOFT instead of pulling
    the whole trajectory quadratically. Re-evaluated each GN iteration
    (IRLS), so weights track the current iterate.

    NOTE: callers must run this under jax.default_matmul_precision
    ("highest"). Reduced-precision matmuls (bf16 operands ~1e-3
    relative, or the TF32 a GPU uses for f32 by default) perturb the
    J^T Omega J products enough to push the pose graph's near-zero gauge
    eigenvalues NEGATIVE, which makes the assembled H indefinite and
    Cholesky NaN (CPU f32 is unaffected). These are 3x3 matmuls — full
    precision is free."""

    def one(idx_i, idx_j, z, omega, m):
        xi = poses[idx_i]
        xj = poses[idx_j]
        e = se2.error_se2(xi, xj, z)
        Ai = jax.jacfwd(lambda a: se2.error_se2(a, xj, z))(xi)   # [3, 3]
        Bj = jax.jacfwd(lambda b: se2.error_se2(xi, b, z))(xj)   # [3, 3]
        w = m.astype(jnp.float32)
        chi = e @ omega @ e
        if robust is not None:
            w_rob, chi = _robust_weight(chi, *robust)
            w = w * w_rob
        AtO = Ai.T @ omega * w
        BtO = Bj.T @ omega * w
        return (AtO @ Ai, AtO @ Bj, BtO @ Bj, AtO @ e, BtO @ e,
                m.astype(jnp.float32) * chi)

    return jax.vmap(one)(
        edges_ij[:, 0], edges_ij[:, 1], edges_z, edges_omega, edge_mask
    )


def _robust_of(cfg: GraphConfig, it=None) -> tuple[str, float] | None:
    """(kind, effective delta) for GN iteration `it` (traced or host int).

    With robust_gnc_iters > 0 the threshold anneals geometrically (10x per
    iteration) from near-quadratic down to cfg.robust_delta — graduated
    non-convexity, so cold-start true loops close before the kernel turns
    fully robust. `it=None` means 'final' (fully robust)."""
    if cfg.robust_kind == "none":
        return None
    delta = cfg.robust_delta
    if it is not None and cfg.robust_gnc_iters > 0:
        scale = 10.0 ** jnp.maximum(
            0.0, jnp.float32(cfg.robust_gnc_iters) - it
        )
        delta = delta * scale
    return cfg.robust_kind, delta


def assemble_normal_eq(poses, edges_ij, edges_z, edges_omega, edge_mask, K: int,
                       robust: tuple[str, float] | None = None):
    """Dense H [3K, 3K], b [3K], chi2 scalar via one scatter-add of blocks."""
    Hii, Hij, Hjj, bi, bj, chi = _edge_blocks(
        poses, edges_ij, edges_z, edges_omega, edge_mask, robust
    )
    H = jnp.zeros((3 * K, 3 * K), jnp.float32)
    b = jnp.zeros((3 * K,), jnp.float32)

    off = jnp.arange(3)
    ri = (3 * edges_ij[:, 0])[:, None] + off[None, :]     # [E, 3]
    rj = (3 * edges_ij[:, 1])[:, None] + off[None, :]

    def rc(r, c):
        return r[:, :, None], c[:, None, :]

    H = H.at[rc(ri, ri)].add(Hii)
    H = H.at[rc(ri, rj)].add(Hij)
    H = H.at[rc(rj, ri)].add(jnp.swapaxes(Hij, 1, 2))
    H = H.at[rc(rj, rj)].add(Hjj)
    b = b.at[ri].add(bi)
    b = b.at[rj].add(bj)
    return H, b, jnp.sum(chi)


def _gn_iterate(poses, H, b, node_mask, cfg: GraphConfig, K: int):
    """One damped GN solve + masked update."""
    anchor = jnp.zeros((3 * K,), jnp.float32).at[:3].set(1e8)
    # inactive node slots get identity diagonal so H stays invertible
    inactive = jnp.repeat(~node_mask, 3).astype(jnp.float32)
    diag = anchor + cfg.damping + inactive
    # symmetrize: scatter-order float noise makes H asymmetric by a few
    # ulp, and Cholesky assumes exact symmetry
    Hd = 0.5 * (H + H.T) + jnp.diag(diag)
    delta = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hd), -b)
    delta = delta.reshape(K, 3) * node_mask[:, None]
    new = poses + delta
    return new.at[:, 2].set(se2.wrap_angle(new[:, 2]))


@jax.jit
def edge_chi2s(poses, g: PoseGraph):
    """Per-edge whitened residual^2 e^T Omega e at `poses` (masked edges
    report 0) — the post-solve consistency statistic the chi-prune gate
    reads: at a converged solution a corridor-aliased loop edge measured
    ~14 where true edges sit at ~0.014 (round-5 endurance diagnosis)."""

    def one(idx_i, idx_j, z, omega, m):
        e = se2.error_se2(poses[idx_i], poses[idx_j], z)
        return m.astype(jnp.float32) * (e @ omega @ e)

    return jax.vmap(one)(
        g.edges_ij[:, 0], g.edges_ij[:, 1], g.edges_z, g.edges_omega,
        g.edge_mask,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def optimize(g: PoseGraph, cfg: GraphConfig):
    """Run cfg.gn_iters Gauss-Newton iterations; returns (graph, chi2)."""
    K = g.poses.shape[0]

    def body(it, carry):
        poses, _ = carry
        H, b, chi = assemble_normal_eq(
            poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, K,
            _robust_of(cfg, it),
        )
        poses = _gn_iterate(poses, H, b, g.node_mask, cfg, K)
        return poses, chi

    # full-f32 matmuls: see _edge_blocks note (reduced-precision
    # matmuls make H indefinite); the graphs are tiny, precision is free
    with jax.default_matmul_precision("highest"):
        poses, chi = jax.lax.fori_loop(
            0, cfg.gn_iters, body, (g.poses, jnp.float32(0.0))
        )
    return g._replace(poses=poses), chi


def make_optimize_sharded(cfg: GraphConfig, mesh, axis: str = "particles"):
    """Edge-sharded distributed GN: each shard assembles (H, b) from its
    edge block, `psum` reduces over the mesh, the small dense solve runs
    replicated (SURVEY.md §4.4 distributed form, first stage)."""
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape[axis]

    def step(poses, node_mask, edges_ij, edges_z, edges_omega, edge_mask):
        K = poses.shape[0]

        def body(it, carry):
            p, _ = carry
            H, b, chi = assemble_normal_eq(
                p, edges_ij, edges_z, edges_omega, edge_mask, K,
                _robust_of(cfg, it),
            )
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)
            chi = jax.lax.psum(chi, axis)
            p = _gn_iterate(p, H, b, node_mask, cfg, K)
            return p, chi

        with jax.default_matmul_precision("highest"):
            return jax.lax.fori_loop(
                0, cfg.gn_iters, body, (poses, jnp.float32(0.0))
            )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None), P(None), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(None), P()),
        check_vma=False,
    )

    @jax.jit
    def run(g: PoseGraph):
        E = g.edges_ij.shape[0]
        pad = (-E) % n_shards
        if pad:
            raise ValueError(f"max_edges={E} must divide {n_shards} shards")
        poses, chi = sharded(
            g.poses, g.node_mask, g.edges_ij, g.edges_z, g.edges_omega,
            g.edge_mask,
        )
        return g._replace(poses=poses), chi

    return run
