"""Weak-scaling benchmark for the device-sharded FastSLAM (BASELINE metric:
"scaling efficiency 1 -> N").

Weak scaling: particles per device held constant while the device count
grows; ideal efficiency keeps scans/s flat as the collectives (psum weight
normalization, all_gather CDF, ring map exchange) absorb the extra width.

This runs on a virtual CPU mesh (--devices N sets
xla_force_host_platform_device_count) — the collective GRAPH is the one a
multi-GPU run lowers, so this validates the scaling structure; absolute
numbers come from runs on the cards.

Prints one JSON line per mesh size plus a summary line with the efficiency.

Isolating evidence for the virtual-mesh artifact (VERDICT r1 item 3): the
observed 1->8 efficiency drop could be (a) the collective graph, or (b) N
virtual devices time-slicing the SAME host cores on compute. Two probes
separate them:

- a COLLECTIVES-ONLY step (the PF's exact collective schedule — pmax/psum
  log-normalization, all_gather of shard weight sums, ring ppermute of the
  full per-particle map stack — with no matcher/update compute). If this
  scales flat while the full step drops, the collectives are exonerated.
- host CPU saturation (process cpu-time / wall / cores) during each timed
  run. Compute-bound time-slicing shows utilization pinned near 1.0 as N
  grows, with total cpu-seconds per scan scaling ~linearly in N.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--particles-per-device", type=int, default=8)
    ap.add_argument("--grid", type=int, default=192)
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU backend with a virtual device mesh")
    args = ap.parse_args()

    if args.cpu or True:  # only CPU meshes are available in this environment
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max(args.devices)}"
        ).strip()

    import jax

    # Force the CPU backend BEFORE any device query (the virtual mesh is
    # a CPU feature).
    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
    )
    from slam2d_tpu.data.synth import SynthWorld, simulate_log
    from slam2d_tpu.parallel.mesh import make_particle_mesh
    from slam2d_tpu.pf.sharded import (
        _global_log_normalize, make_sharded_chunk_fn, sharded_fastslam_init,
    )

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=90, max_range=10.0),
        grid=GridConfig(
            height=args.grid, width=args.grid, resolution=0.1,
            ray_samples=96, center_x=6.0, center_y=6.0,
        ),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=7),
        chunk=16,
        bootstrap_dist=1.0,
    )
    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 9.0], [9.0, 9.0], [9.0, 3.5], [3.5, 3.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.1, seed=0)
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = min(args.scans, (len(odom) // cfg.chunk) * cfg.chunk)

    import functools

    from jax.sharding import PartitionSpec as P

    n_cores = os.cpu_count() or 1

    @functools.lru_cache(maxsize=None)
    def make_collectives_only_fn(n: int, P_local: int, steps: int,
                                 refine_every: int = 1,
                                 ring_every: int = 1):
        """The sharded PF step's collective schedule with NO local compute.

        refine_every=ring_every=1 is the historical UPPER bound (every
        collective every scan). The round-4 production schedule gates
        the weight collectives off no-refine scans and the CDF/ring
        behind the resample trigger — refine_every=3, ring_every=20
        models that cadence (measured: refines ~1 in 3 scans, resamples
        ~1 in 20; ancestor histogram shows the ring's hops are ~all
        dead even then)."""
        mesh = make_particle_mesh(n)
        axis = "particles"
        perm = [(i, (i + 1) % n) for i in range(n)]

        def step(i, log_w, maps):
            def norm(lw):
                # the REAL normalize (pf/sharded._global_log_normalize):
                # one packed [3]-stat all_gather since round 5 (was
                # pmax + 2 sequential psums)
                lw2, ne = _global_log_normalize(lw, axis)
                return lw2 + 0.0 * ne

            log_w = jax.lax.cond(
                i % refine_every == 0, norm, lambda lw: lw, log_w
            )

            def resample(args):
                lw, mp = args
                shard_sums = jax.lax.all_gather(jnp.sum(jnp.exp(lw)), axis)
                mp = jax.lax.ppermute(mp, axis, perm)
                return lw + 0.0 * jnp.sum(shard_sums), mp

            log_w, maps = jax.lax.cond(
                i % ring_every == 0, resample, lambda a: a, (log_w, maps)
            )
            # packed best-pose gather rides every step (trajectory out)
            cand = jax.lax.all_gather(log_w[:5], axis)
            return log_w + 1e-20 * cand[0, 0], maps

        def many(log_w, maps):
            def body(carry, i):
                lw, mp = carry
                lw, mp = step(i, lw, mp)
                return (lw, mp), lw[0]

            (log_w, maps), _ = jax.lax.scan(
                body, (log_w, maps), jnp.arange(steps)
            )
            return log_w, maps

        return mesh, jax.jit(
            jax.shard_map(
                many, mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=(P(axis), P(axis)),
                check_vma=False,
            )
        )

    @functools.lru_cache(maxsize=None)
    def make_per_collective_fns(n: int, P_local: int, grid: int,
                                steps: int):
        """Each collective KIND in the PF schedule timed in isolation
        (VERDICT r3 item 4: 'explain the 0.419'): the normalize's
        pmax+2*psum scalars, the resample CDF all_gather [P_local], the
        packed best-pose all_gather [5], and one ring ppermute hop of the
        full [P_local, grid*grid] map block."""
        mesh = make_particle_mesh(n)
        axis = "particles"
        perm = [(i, (i + 1) % n) for i in range(n)]

        def scan_of(one):
            def many(*xs):
                def body(c, _):
                    c2 = one(*c)
                    return c2, c2[0].ravel()[0]

                c, _ = jax.lax.scan(body, xs, None, length=steps)
                return c

            return many

        def norm_step(lw):
            lw2, ne = _global_log_normalize(lw, axis)
            return (lw2 + 0.0 * ne,)

        def cdf_step(lw):
            lw_all = jax.lax.all_gather(lw, axis, tiled=True)
            return (lw + 1e-12 * lw_all[0],)

        def best_step(lw):
            cand = jax.lax.all_gather(lw[:5], axis)
            return (lw + 1e-12 * cand[0, 0],)

        def ring_step(maps):
            return (jax.lax.ppermute(maps, axis, perm),)

        fns = {}
        for name, one, spec in (
            ("normalize_psum", norm_step, P(axis)),
            ("cdf_all_gather", cdf_step, P(axis)),
            ("best_pose_all_gather", best_step, P(axis)),
            ("ring_ppermute_hop", ring_step, P(axis, None)),
        ):
            fns[name] = jax.jit(jax.shard_map(
                scan_of(one), mesh=mesh, in_specs=(spec,),
                out_specs=(spec,), check_vma=False,
            ))
        return mesh, fns

    rates, coll_rates, cpu_util = {}, {}, {}
    coll_rates_prod = {}
    per_coll = {}
    ring_hist = {}
    for n in args.devices:
        pf = PFConfig(n_particles=args.particles_per_device * n)
        mesh = make_particle_mesh(n)
        state = sharded_fastslam_init(
            cfg, pf, jax.random.PRNGKey(0), mesh, start_pose=odom[0]
        )
        state = state._replace(prev_odom=jnp.asarray(odom[0]))
        chunk_fn = make_sharded_chunk_fn(cfg, pf, mesh)

        # warmup chunk (compile)
        state, out = chunk_fn(
            state, jnp.asarray(odom[: cfg.chunk]), jnp.asarray(ranges[: cfg.chunk])
        )
        np.asarray(out[0])

        t0 = time.perf_counter()
        c0 = sum(os.times()[:2])
        done = 0
        for s in range(cfg.chunk, T, cfg.chunk):
            state, out = chunk_fn(
                state,
                jnp.asarray(odom[s : s + cfg.chunk]),
                jnp.asarray(ranges[s : s + cfg.chunk]),
            )
            done += cfg.chunk
        np.asarray(out[0])
        dt = time.perf_counter() - t0
        cpu_s = sum(os.times()[:2]) - c0
        rates[n] = done / dt
        cpu_util[n] = cpu_s / (dt * n_cores)
        print(
            json.dumps(
                {
                    "metric": "sharded_pf_scans_per_sec",
                    "devices": n,
                    "particles": pf.n_particles,
                    "value": round(rates[n], 2),
                    "unit": "scans/s",
                    "cpu_seconds": round(cpu_s, 2),
                    "host_cpu_utilization": round(cpu_util[n], 3),
                    "host_cores": n_cores,
                }
            )
        )

        # ancestor-ring distance histogram from the REAL run (validates
        # the ring's d_max claim: systematic ancestors cluster near their
        # own shard, so most hops are dead)
        from slam2d_tpu.pf.sharded import make_sharded_step

        stats_step = jax.jit(
            make_sharded_step(cfg, pf, mesh, ring_stats=True)
        )
        st2 = sharded_fastslam_init(
            cfg, pf, jax.random.PRNGKey(0), mesh, start_pose=odom[0]
        )
        st2 = st2._replace(prev_odom=jnp.asarray(odom[0]))
        kneeds = []
        for t in range(T):
            st2, out = stats_step(
                st2, jnp.asarray(odom[t]), jnp.asarray(ranges[t])
            )
            kneeds.append(np.asarray(out[3]))
        kn = np.concatenate(kneeds)
        hist = np.bincount(kn, minlength=n)
        ring_hist[n] = [int(v) for v in hist]
        print(json.dumps({
            "metric": "ancestor_ring_distance_histogram",
            "devices": n,
            "histogram": ring_hist[n],
            "frac_zero_hops": round(float(hist[0]) / max(kn.size, 1), 4),
        }))

        # per-collective isolation at the same shapes
        cmesh2, cfns = make_per_collective_fns(
            n, pf.n_particles, args.grid, cfg.chunk
        )
        per_coll[n] = {}
        for cname, fn in cfns.items():
            if cname == "ring_ppermute_hop":
                x = (jnp.zeros(
                    (pf.n_particles, args.grid * args.grid), jnp.float32
                ),)
            else:
                x = (jnp.zeros(pf.n_particles, jnp.float32),)
            (y,) = fn(*x)    # compile
            np.asarray(y.ravel()[0])
            reps = max(1, T // cfg.chunk)
            # min-of-5: single-pass timings on this 2-core host carry
            # scheduler-noise spikes of 2-4x (round-5 finding); the min
            # is the reproducible cost
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(reps):
                    (y,) = fn(y if cname != "ring_ppermute_hop" else y,)
                np.asarray(y.ravel()[0])
                best = min(best, time.perf_counter() - t0)
            us = best / (reps * cfg.chunk) * 1e6
            per_coll[n][cname] = round(us, 1)
        print(json.dumps({
            "metric": "per_collective_step_cost_us",
            "devices": n,
            **per_coll[n],
        }))

        # collectives-only probes at the same shapes: the historical
        # every-step upper bound AND the production-cadence schedule
        steps = T
        for tag, re_, ri_ in (("", 1, 1), ("_production_cadence", 3, 20)):
            cmesh, coll_fn = make_collectives_only_fn(
                n, pf.n_particles, cfg.chunk, re_, ri_
            )
            log_w = jnp.zeros(pf.n_particles, jnp.float32)
            maps = jnp.zeros(
                (pf.n_particles, args.grid, args.grid), jnp.float32
            )
            lw, mp = coll_fn(log_w, maps)   # compile
            np.asarray(lw)
            dt = float("inf")
            for _ in range(5):   # min-of-5 (scheduler-noise spikes)
                t0 = time.perf_counter()
                for _ in range(steps // cfg.chunk):
                    lw, mp = coll_fn(lw, mp)
                np.asarray(lw)
                dt = min(dt, time.perf_counter() - t0)
            if tag == "":
                coll_rates[n] = steps / dt
            else:
                coll_rates_prod[n] = steps / dt
            print(
                json.dumps(
                    {
                        "metric": f"collectives_only{tag}_steps_per_sec",
                        "devices": n,
                        "value": round(steps / dt, 2),
                        "unit": "steps/s",
                    }
                )
            )

    base = args.devices[0]
    top = max(args.devices)
    eff = rates[top] / rates[base]
    # collectives-only efficiency baselines at the FIRST MULTI-device
    # mesh: with min-of-5 timing (round 5) the n=1 "collectives" are
    # no-ops and its rate is a degenerate ~25k steps/s baseline that
    # made the old 1->N ratio meaningless noise; 2->N compares real
    # collective schedules at growing width.
    cbase = min(n for n in args.devices if n > 1) if top > 1 else base
    coll_eff = coll_rates[top] / coll_rates[cbase]
    coll_eff_prod = coll_rates_prod[top] / coll_rates_prod[cbase]
    print(
        json.dumps(
            {
                "metric": "weak_scaling_efficiency",
                "value": round(eff, 3),
                "unit": f"x{base}->{top}dev",
                "vs_baseline": round(eff / 0.8, 3),  # target >= 0.8
            }
        )
    )
    # Structure evidence that works on a shared-core host: on N VIRTUAL
    # devices all compute serializes onto the same cores, so wall-clock
    # weak scaling is physically capped at cores/devices once saturated —
    # the wall number cannot certify pod behavior. What CAN be read off:
    # total cpu-seconds per timed run. Ideal weak scaling on real chips
    # needs per-device work ~constant, i.e. total compute volume ~N. If
    # cpu-seconds grow SUBLINEARLY in N, the virtual-mesh wall drop is
    # per-step overhead/serialization, not collective volume; superlinear
    # growth would implicate the collective graph itself (e.g. the ring
    # exchange's O(N) hops per device — which is why it is N_eff-gated
    # and why the collectives-only probe rings EVERY step as an upper
    # bound).
    work_growth = (
        cpu_util[top] * rates[base] / (cpu_util[base] * rates[top])
    )  # = cpu_seconds_per_scan(top) / cpu_seconds_per_scan(base)
    host_bound = n_cores < top
    if host_bound:
        interp = (
            f"host has {n_cores} cores for {top} virtual devices — wall "
            f"efficiency is core-bound, not a pod prediction; compute "
            f"volume per scan grew {work_growth:.2f}x for {top}x width "
            + ("(sublinear: overhead-dominated, collective graph sound)"
               if work_growth < 0.8 * top else
               "(SUPERLINEAR in width: collective graph implicated)")
        )
    else:
        interp = (
            "collectives scale; full-step drop tracks host-core saturation"
            if coll_eff >= 0.8 else
            "collective graph implicated — see per-N lines"
        )
    print(
        json.dumps(
            {
                "metric": "weak_scaling_evidence",
                "collectives_only_efficiency": round(coll_eff, 3),
                "collectives_production_cadence_efficiency": round(
                    coll_eff_prod, 3
                ),
                "collectives_efficiency_base_devices": cbase,
                "cpu_seconds_per_scan_growth": round(work_growth, 2),
                "width_growth": top // base,
                "host_cpu_utilization": {
                    str(k): round(v, 3) for k, v in cpu_util.items()
                },
                "host_cores": n_cores,
                "host_bound": host_bound,
                "interpretation": interp,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
