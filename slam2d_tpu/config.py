"""Frozen config dataclasses (SURVEY.md §7 "Config / flag system").

The reference hard-codes constants in scripts; here every stage is driven by
a frozen dataclass so configs can be static jit arguments. All shapes derived
from these are static — XLA never sees a dynamic shape.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """2D planar laser model (CARMEN FLASER-style: 180deg FOV, 1deg steps)."""

    n_beams: int = 180
    fov_rad: float = math.pi          # 180 degrees
    min_range: float = 0.10           # ranges below this are invalid
    max_range: float = 12.0           # clip; CARMEN logs report 81.9 for no-hit
    # Angle of beam 0 relative to robot heading (CARMEN: -90 deg).
    angle_min: float = -math.pi / 2.0

    def beam_angles(self):
        import numpy as np

        step = self.fov_rad / max(self.n_beams - 1, 1)
        return self.angle_min + step * np.arange(self.n_beams)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Fixed-capacity world-anchored log-odds grid (SURVEY.md §4.2).

    The reference grows its arrays when the robot nears a border; we use a
    fixed [H, W] tensor (static shapes for XLA) whose world origin is chosen
    at init. `tile` variants come from slam2d_tpu.grid.tiles.
    """

    height: int = 1024
    width: int = 1024
    resolution: float = 0.10          # meters per cell
    # World coordinate of the *center* cell (H//2, W//2).
    center_x: float = 0.0
    center_y: float = 0.0
    l_occ: float = 0.85               # log-odds increment for an endpoint hit
    l_free: float = -0.40             # log-odds increment per free-space sample
    l_clamp: float = 10.0             # |log-odds| clamp
    # Static number of free-space samples per beam; sample spacing adapts to
    # the actual range so shapes stay static (SURVEY.md §9 "static shapes").
    # Only used by the sparse ("raycast") update implementation.
    ray_samples: int = 192
    # Scan-integration kernel (grid.occupancy.resolve_update_impl). "auto"
    # (default) = "sparse" on every backend: sampled rays accumulated with
    # XLA's scatter-add. Explicit choices: "sparse_mxu" (the same rays,
    # one-hot-matmul accumulation) and "dense" (inverse sensor model
    # evaluated at every cell of the window).
    update_impl: str = "auto"

    @property
    def origin_x(self) -> float:
        return self.center_x - (self.width // 2) * self.resolution

    @property
    def origin_y(self) -> float:
        return self.center_y - (self.height // 2) * self.resolution


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Correlative scan matcher (SURVEY.md §4.1).

    Search is over a fixed (theta, y, x) window around the odometry prior.
    Coarse pass uses a max-pooled ("conservative", Olson-2009 style) search
    space at `coarse_factor`x lower resolution over the full window; the fine
    pass searches +/- one coarse cell at full resolution.
    """

    # Translation search half-window, meters (full window = 2*r + 1 cells).
    search_xy: float = 0.4
    # Rotation half-window and step, radians.
    search_theta: float = 0.20
    n_theta: int = 17                 # odd: includes delta-theta = 0
    coarse_factor: int = 4            # coarse grid pooling factor
    # Gaussian blur sigma for the search space, in METERS (converted to cells
    # at the grid's resolution, so behavior is resolution-independent).
    sigma_m: float = 0.10
    # Candidate-scoring kernel (match.correlative._resolve_impl): "auto" =
    # "gather" (direct XLA gather) on every backend. Explicit one-hot
    # matmul formulations: "mxu", "mxu_int8" (int8 operands) and "emx"
    # (endpoint-image cross-correlation).
    score_impl: str = "auto"
    # bf16 operands (f32 accumulate) in the one-hot-matmul scorers; score
    # noise ~0.1% of range.
    score_bf16: bool = True
    # Fine-pass theta restriction (pyramid path only): the coarse pass
    # already searches ALL n_theta bins at the SAME theta resolution (the
    # pyramid only coarsens translation), so the fine pass re-scoring
    # every theta is redundant work — it searches only +-fine_theta_bins
    # bins around the coarse theta winner (a dynamic slice of the same
    # theta grid; value-dynamic, shape-static). The fine pass's work
    # scales with the theta count (13 -> 5 bins at ATE parity). <0 = full
    # grid. The single-pass (no-pyramid) path always searches the full
    # grid.
    fine_theta_bins: int = 2
    occ_threshold: float = 0.5        # p(cell) above this counts as occupied
    occ_evidence_sat: float = 2.0     # log-odds at which a cell counts as a full wall
    free_threshold: float = 0.45      # p(cell) below this counts as known-free
    free_penalty: float = 0.6         # negative field value deep in free space
    min_score: float = 0.15           # below: distrust match, keep prior
    # Weight of the Gaussian motion prior penalty subtracted from the score
    # surface (score units per m^2 / rad^2). Breaks plateau ties toward the
    # odometry prior and regularizes low-texture matches.
    prior_xy_weight: float = 2.0
    prior_theta_weight: float = 2.0

    def n_xy(self, resolution: float) -> int:
        """Fine-resolution full window size (odd) in cells."""
        r = int(round(self.search_xy / resolution))
        return 2 * r + 1


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """FastSLAM particle filter (SURVEY.md §4.3)."""

    n_particles: int = 32
    # Odometry proposal noise (std-dev) on x, y, theta per step.
    # TUNE TO THE LOG'S ODOMETRY NOISE — the single most important PF
    # constant (round-4 fine-res study, 0.05 m/1024^2/P=100 on a
    # log with 0.004/0.002 odometry noise: proposal 0.02/0.01 -> ATE
    # 0.446, 0.01/0.005 -> 0.290, 0.005/0.0025 -> 0.213-0.231 (3
    # seeds), matched 0.004/0.002 -> 0.177; going BELOW the odometry
    # noise degrades again, 0.002/0.001 -> 0.222). These defaults
    # target sensor-spec-grade odometry (~0.03-0.05 m/step drift);
    # benches and parity tests pass log-matched values explicitly.
    noise_xy: float = 0.04
    noise_theta: float = 0.02
    # Per-particle refinement matcher overrides (None = inherit the
    # frontend matcher config). A smaller window here cuts the dominant
    # per-particle cost roughly proportionally.
    refine_xy: float | None = None
    refine_theta: float | None = None
    refine_n_theta: int | None = None
    # Motion-prior weight for the refinement matcher (None = inherit the
    # frontend matcher's 2.0). THE decisive constant for beating good
    # odometry (round-5 study, 0.05 m/1024^2/P=100, matched
    # proposal noise): the round-4 gap (PF 0.177 vs odom 0.154) was not
    # in sharpness/gates/windows — all measured neutral-or-worse — but
    # in the prior being too weak to regularize sub-cell matcher noise
    # when odometry is spec-grade. Sweep: 2 -> 0.177, 10 -> mean 0.136
    # (2/3 seeds beat odom), 16 -> 0.135/0.140/0.147 (ALL 3 seeds beat
    # odom 0.154). Coarse-res configs with noisier odometry keep the
    # inherited 2.0 (a strong prior would just reproduce bad odometry).
    refine_prior_weight: float | None = None
    # Scoring kernel for the refinement matcher (None = inherit; an
    # inherited "auto" resolves as "auto_refine", i.e. the gather scorer).
    refine_score_impl: str | None = None
    # Refinement batching strategy. "shared" scores every particle through
    # one matmul against a scan-shared endpoint-splat shift stack on a
    # global theta grid (pf/shared_refine.py); "per_particle" vmaps the
    # frontend matcher per particle (the reference-shaped formulation).
    # "auto" = "per_particle" on every backend.
    refine_mode: str = "auto"
    # Extra global-theta slots on EACH side of the matcher's n_theta grid
    # in shared mode, covering the particles' heading spread around the
    # circular mean (each slot costs one more R*C block of the shared
    # stack — cheap). Particles whose heading drifts beyond the padded
    # grid search a clipped theta range.
    refine_theta_pad: int = 3
    resample_threshold: float = 0.5   # resample when N_eff < threshold * N
    # Log-weight increment = sharpness * match score (score in [-pen, 1]);
    # controls how aggressively weights concentrate on good particles.
    weight_sharpness: float = 30.0
    # Per-particle map storage dtype: "bfloat16" halves device memory and
    # the bandwidth of updates/resampling rings (log-odds clamp at +-10
    # keeps bf16 ulp <= 0.06 — well under the +-0.4/0.85 increments);
    # bench_pf.py uses it. The library default stays f32 so tests and
    # comparators see exact arithmetic.
    map_dtype: str = "float32"
    # Refine/update particles in chunks of this size via lax.map (0 = all
    # at once) — bounds the per-particle intermediates' device memory at
    # 1000+ particles (the one-hot-matmul scorers materialize ~13 MB of
    # operands per particle).
    refine_chunk: int = 0
    # Map-update batching strategy (mirrors refine_mode). "shared" builds
    # G scan update images on a global theta grid and applies them per
    # particle as lattice-anchored shifted adds (pf/shared_update.py) —
    # the update kernel runs G times instead of P times. Marks quantize to
    # the pose's cell center + theta slot (sub-half-cell; poses/weights
    # stay exact). "auto" = "per_particle" on every backend.
    update_mode: str = "auto"
    update_theta_slots: int = 16
    # Sub-cell anchor grid for the shared update's images: each theta
    # slot splits into update_subcell^2 sensor-offset variants inside the
    # anchor cell, cutting the translation quantization error from res/2
    # to res/(2*update_subcell) per axis at subcell^2 x the image-build
    # cost. 1 = plain cell-center anchoring.
    update_subcell: int = 1
    # Bilinear sub-cell image placement in the shared update: the slot
    # image lands at anchor + fractional offset via a 2x2-tap blend (the
    # increment's centroid sits exactly at the particle position), which
    # removes the TRANSLATION quantization to first order at no extra memory
    # traffic — unlike update_subcell, which multiplies the image-build
    # cost by subcell^2. Ignored when update_subcell > 1.
    update_bilinear: bool = False
    # Exact-endpoint shared update: the shared slot images carry the
    # FREE-SPACE carve only (l_occ=0) and each particle's occupancy
    # marks are added at its EXACT endpoint cells afterwards (~B points,
    # scatter-add). Axis probes pinned the shared update's ATE gap on the
    # TRANSLATION snap (quantized_xy_only 4-seed mean 0.250 vs
    # quantized_theta_only 0.183 vs per_particle 0.166); the matcher
    # locks onto the occupancy peaks, so those must not snap — the smooth
    # carve can. Supersedes update_bilinear/update_subcell (which blur or
    # multiply the image build instead).
    update_exact_endpoints: bool = True
    # Anchor dithering for the shared update's free-space carve (the
    # exact-endpoint marks never snap): "random" adds an independent
    # uniform(-res/2, res/2) per-particle offset to the ANCHOR choice at
    # every update event, decorrelating the carve's translation snap
    # across particles and time — after a resample the cloud collapses
    # to near one cell, so without dither every particle's map carries
    # the SAME snap-error history and the ensemble cannot average it out
    # (the round-4 residual's "slot-boundary chaos" suspect). "off"
    # keeps the deterministic snap. "theta_phase" jitters the GLOBAL
    # theta-slot grid's phase by uniform(-step/2, step/2) per update
    # event instead — the direct A/B for the slot-boundary-chaos
    # hypothesis (particles near a slot boundary flip slots chaotically
    # across events; a jittered grid turns the flip into an unbiased
    # average). "both" combines the two.
    update_anchor_dither: str = "off"
    # Cells to pull the exact-endpoint mode's shared carve short of the
    # measured range (protects the exact marks from the snapped carve
    # crossing them; 0 = carve to the standard one-cell stop). Chip A/B
    # (4 seeds): 0.0 measures mean ATE 0.199 vs 1.0's 0.210 — the lost
    # free evidence near walls costs more than the occasional mark
    # erosion it prevents; 0 is the default.
    update_carve_shrink: float = 0.0
    # Host-gated dispatch: fuse up to this many dead-reckoning scans into
    # the FRONT of each heavy dispatch (make_heavy_step_fused) — one
    # dispatch per heavy event instead of a separate light segment before
    # it. 0 disables (the sharded driver's custom factories always run
    # unfused). Outputs are bit-identical to the unfused host-gated loop.
    fuse_light_prefix: int = 8
    # Target ROTATION quantization of the shared update, as max endpoint
    # displacement in CELLS at the sensor's max range: the theta-slot
    # step is 2 * update_qstep_cells * res / max_range (so a particle's
    # residual rotation within a slot displaces its farthest mark by at
    # most update_qstep_cells cells). 0.5 = the original half-cell step.
    # NOTE: independent of update_theta_slots — G only sets COVERAGE
    # (G * step around the cloud's circular mean); halving qstep_cells
    # therefore wants G doubled to keep the same heading-spread coverage
    # before the adaptive spread floor kicks in.
    update_qstep_cells: float = 0.5
    # Driver dispatch strategy threshold: host-gated stage dispatch issues
    # ~one program per scan, whose host-side dispatch cost only amortizes
    # when per-scan device work is larger. run_fastslam's host_gated=None
    # resolves to n_particles >= this (ROADMAP A5 re-derives it from the
    # GPU trace's idle share).
    host_gate_min_particles: int = 512


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Pose-graph backend (SURVEY.md §4.4)."""

    keyframe_dist: float = 0.5        # admit keyframe every d meters ...
    keyframe_angle: float = 0.5       # ... or psi radians
    max_nodes: int = 512              # static node capacity
    max_edges: int = 2048             # static edge capacity
    gn_iters: int = 10
    loop_radius: float = 3.0          # spatial gate for loop candidates
    loop_min_gap: int = 20            # min keyframe index gap for a loop
    # Accept gates chosen from a measured precision/recall sweep over
    # 180 GT-labeled attempts on loop-dense scenarios incl. an
    # alias-stress family (docs/LOOP_GATES.md, scripts/sweep_loop_gates
    # .py): this operating point sits in the measured precision-1.0
    # region at recall ~0.91 — one false accept costs ~0.4 ATE (the
    # round-3 stale-prior alias) while a missed true loop only waits a
    # few keyframes for the next attempt.
    loop_score_accept: float = 0.45   # matcher score to accept a loop edge
    # Plausibility gate: reject a loop whose implied correction of the
    # current estimate exceeds these bounds (guards against corridor-aliased
    # matches that score well but are shifted by multiples of the structure
    # period; SCALE UP for long-drift datasets — the endurance/Killian
    # benches run 2.5 m).
    loop_max_correction_xy: float = 1.0
    loop_max_correction_theta: float = 0.4
    # Drift-relative relaxation of the plausibility gate (ADVICE r4): the
    # fixed bounds above were tuned on two-lap scenarios with modest
    # drift; on long-drift logs a TRUE first closure implies a correction
    # proportional to the odometry drift accumulated along the path
    # between the matched keyframes (since the last closure). The
    # effective bound is max(fixed, rate * path_length), where
    # path_length is the keyframe arc length from max(i, last accept) to
    # k_new — tight in low-drift regimes (the measured precision-1.0
    # point is unchanged there), scaling with real travel on endurance/
    # Killian-length excursions so defaults no longer silently reject
    # long-drift closures. 3%/m xy covers the synth drift model
    # (sigma_xy 0.02/m, 1.5 sigma) and typical Radish logs; 0 disables.
    loop_correction_drift_xy: float = 0.03    # m of bound per m travelled
    loop_correction_drift_theta: float = 0.012  # rad of bound per m
    # Post-solve consistency prune: after each accepted-loop optimize,
    # loop edges whose whitened residual^2 at the CONVERGED solution
    # exceeds this are disabled permanently and the graph re-solved
    # (round-5 endurance diagnosis: two corridor-aliased closures passed
    # every accept gate — scores 0.68/0.79, healthy peak margins — and
    # DCS only attenuated them; their converged chi^2 was ~14 vs ~0.014
    # for true edges, a 1000x separation, so a 3-sigma gate at 9 removes
    # them with enormous headroom). 0 disables.
    loop_prune_chi2: float = 9.0
    # Skip loop attempts for this many keyframes after an accepted loop
    # (consecutive keyframes re-close the same loop with little new info).
    loop_cooldown: int = 3
    # Peak-dominance gate: reject loops whose coarse score surface has a
    # second peak (outside 0.5 m of the best) within this margin of the
    # best — aliased corridor matches show near-equal peaks (calibrated:
    # ambiguous ~0.03, unique >= 0.13). Complements (does NOT replace) the
    # magnitude gate: a true peak OUTSIDE the search window still leaves a
    # clean-looking aliased surface. 0 disables.
    loop_min_peak_margin: float = 0.05
    # Robust kernel on edge residuals, IRLS-reweighted each GN iteration
    # (weights track the current iterate). Guards against false-positive
    # loop edges that slip past the accept gates:
    #   "none"  — pure quadratic GN (the reference's behavior).
    #   "huber" — w = min(1, delta/||e||_Omega): constant influence past
    #             delta. Safe for COLD STARTS (a true loop closing a large
    #             drift keeps pulling at full constant force until closed)
    #             but only linearly attenuates a gross false edge.
    #   "dcs"   — Dynamic Covariance Scaling (Agarwal et al. 2013):
    #             w = min(1, 2*Phi/(Phi + chi2))^2 with Phi = delta^2.
    #             Redescending: a gross outlier's influence -> 0, so one
    #             wrong loop edge barely moves the trajectory — but a TRUE
    #             loop with a huge initial residual (first closure after
    #             long drift) is also suppressed; drivers mitigate by
    #             seeding the solve from gate-checked corrections.
    # delta is in whitened-residual units (||e||_Omega = sqrt(e^T Omega e)).
    robust_kind: str = "none"
    robust_delta: float = 3.0
    # Graduated non-convexity (GNC, Yang et al. 2020 flavor): for the first
    # robust_gnc_iters GN iterations the robust threshold is inflated by
    # 10x per remaining iteration (iteration k uses delta * 10^(G-k)), so
    # the solve STARTS near-quadratic — a true loop closing a large drift
    # (first closure after a long excursion; measured cold-start: plain
    # DCS suppresses a 7.5 m correction entirely, ATE stays at odometry)
    # gets pulled in while the surrogate is still convex — and ENDS fully
    # robust, so an edge that stays inconsistent with the converged graph
    # is rejected. Trade-off (measured): a STIFF false edge can be
    # "absorbed" during a long quadratic phase (satisfied well enough to
    # look like an inlier: gnc=5 leaves 0.54 m ATE where gnc=2 leaves
    # 0.0002), while very large TRUE corrections need more quadratic
    # iterations (translational 7.5 m: gnc=2 -> 0.28, gnc=5 -> 0.013 m).
    # Default 2 favors outlier rejection — the driver's accept gates bound
    # true-loop corrections to loop_max_correction_xy, which 2 quadratic
    # iterations comfortably close. 0 = robust from the first iteration.
    robust_gnc_iters: int = 2
    damping: float = 1e-6             # Levenberg damping on H diagonal
    # Matrix-free optimizer (graph/sparse.py optimize_cg): STATIC
    # capacity for loop (non-chain) edges deflated into the coarse
    # space — the coarse system is [3*(max_nodes/stride) + 6*Lmax]^2.
    # Loop edges past the capacity cost extra CG iterations; size it
    # >= the driver's accepted-loop bound (full-SLAM's cooldown gate
    # caps the accept rate at ~n_keyframes / loop_cooldown).
    sparse_max_loops: int = 64
    # Chain coarsening stride for the two-level preconditioner: the
    # coarse anchor chain has max_nodes/stride nodes whose condition
    # (~ (K/stride)^2) must stay f32-Cholesky-safe; 16 holds to
    # ~64k keyframes.
    sparse_coarse_stride: int = 16
    # Inner PCG iterations per GN step. The two-level preconditioner
    # clusters the spectrum (chain modes ~1, loop outliers deflated);
    # measured: 48 converges the 4096-node serpentine to solver noise.
    sparse_cg_iters: int = 48
    # optimize_hier recursion threshold: coarsen by sparse_coarse_stride
    # until the anchor chain fits an ACCURATE f32 dense Cholesky. The
    # boundary TIGHTENS with depth (each level divides the chain
    # information by stride, so the coarse loop/chain info ratio grows:
    # a 1024-anchor coarse of K=16384 measured NaN where flat K=1024
    # graphs solve fine); 512 held at every measured K. One level to
    # ~8k keyframes, two to ~128k (round 5).
    hier_dense_max: int = 512
    # Full V-cycles optimize_hier runs; >1 re-coarsens from the improved
    # iterate, which converges the global modes the first cycle's f32
    # coarse solve leaves behind (bench_hier_floor.py: K=4096 err
    # 0.056 -> 7e-5 = the f64 reference's own convergence noise;
    # K=16384 0.44 -> 0.040) at ~2x the solve cost — accepts are rare,
    # so 2 is the default.
    sparse_hier_cycles: int = 2


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Everything the scan-matching frontend needs (configs 1-2)."""

    sensor: SensorConfig = SensorConfig()
    grid: GridConfig = GridConfig()
    matcher: MatcherConfig = MatcherConfig()
    # Scans per lax.scan chunk in the driver loop.
    chunk: int = 32
    # Bootstrap: trust odometry (no matching) until this much travel, while
    # integrating every scan — a single-viewpoint map is a string of beam
    # endpoints ("beads") that drags incremental matching backward; waiting
    # for viewpoint diversity before trusting the matcher kills the early
    # transient that otherwise bakes error into the map.
    bootstrap_dist: float = 3.0
    # Localization-only: track against a FIXED prebuilt map (no bootstrap,
    # no map updates, search space built once) — AMCL-style pose tracking.
    # Set via run_localization / CLI --mode localize.
    localize_only: bool = False
    # Motion filter: after bootstrap, only integrate a scan into the map
    # when the robot moved/rotated this much since the last integration
    # (reduces same-viewpoint map poisoning; Cartographer-style).
    map_update_min_motion: float = 0.30
    map_update_min_rot: float = 0.25
    # Match gate: only run the correlative matcher after this much motion /
    # rotation since the last accepted match; between matches the pose is
    # dead-reckoned from odometry. High-rate logs otherwise give the
    # per-match backward drag (see bootstrap_dist) more opportunities per
    # meter of travel, and matching a barely-moved scan adds no information.
    # (Tune per dataset: on the noisy fine-res (0.05 m) bench trajectory,
    # 0.25 m measured ~2x better ATE than 0.15 m — each match is slightly
    # biased toward the map's newest content, so fewer matches per meter
    # drift less there — while the 0.1 m-res scenarios prefer 0.15.)
    match_min_motion: float = 0.15
    match_min_rot: float = 0.10
    # lax.scan unroll factor for the per-chunk device loop: unrolling
    # amortizes the loop machinery across N scan bodies per iteration at
    # the cost of a bigger program.
    scan_unroll: int = 1
    # Chunks per device dispatch in the streaming driver: each dispatch
    # runs an OUTER lax.scan over M inner `chunk`-trip scans (bit-
    # identical to M separate dispatches — no state crosses a chunk
    # boundary outside the carried FrontendState). Motivation (round-5
    # dispatch decomposition): fewer, longer dispatches amortize the
    # per-dispatch host cost, while per-scan device cost grew with the
    # scans one program covers; M=2 at chunk=64 was the earlier optimum
    # (ROADMAP A5 re-derives it from the GPU trace). COMPILE NOTE: a log
    # whose chunk count is not a multiple of M also compiles the
    # single-chunk program for the tail (two compiles instead of one; the
    # entry points keep a persistent compile cache, or feed group-aligned
    # logs as bench.py does). The tail deliberately does NOT pad to a full
    # group: padding semantics (repeat-last-record) interact with
    # in-bootstrap integration and armed match gates, so grouped and
    # ungrouped runs would no longer return bit-identical final states.
    chunks_per_dispatch: int = 2
