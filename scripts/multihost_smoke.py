"""Two-process jax.distributed smoke test (SURVEY.md §6 "Multi-host").

Run with no args: forks itself into 2 coordinator/worker processes on the
CPU backend, builds a global particle mesh spanning both processes, runs
one sharded FastSLAM step, and checks the psum'd N_eff agrees. This is the
same bring-up path a multi-host run uses (jax.distributed.initialize +
global devices); only the transport differs.

    python scripts/multihost_smoke.py
"""

from __future__ import annotations

import os
import subprocess
import sys


def worker(pid: int, nproc: int, port: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from slam2d_tpu.parallel.mesh import init_distributed

    init_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    n_global = len(jax.devices())
    assert n_global == 2 * nproc, (n_global, nproc)

    import jax.numpy as jnp
    import numpy as np

    from slam2d_tpu.config import (
        FrontendConfig, GridConfig, MatcherConfig, PFConfig, SensorConfig,
    )
    from slam2d_tpu.parallel.mesh import make_particle_mesh
    from slam2d_tpu.pf.sharded import make_sharded_step, sharded_fastslam_init

    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=16, max_range=6.0),
        grid=GridConfig(height=64, width=64, resolution=0.1,
                        ray_samples=32, center_x=0.0, center_y=0.0),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=3),
        bootstrap_dist=0.0,
        match_min_motion=0.0,
    )
    pf = PFConfig(n_particles=2 * n_global)
    mesh = make_particle_mesh()
    state = sharded_fastslam_init(cfg, pf, jax.random.PRNGKey(0), mesh)
    step = jax.jit(make_sharded_step(cfg, pf, mesh))
    state2, (bp, n_eff, sc) = step(
        state,
        jnp.asarray([0.05, 0.0, 0.0], jnp.float32),
        jnp.full((16,), 4.0, jnp.float32),
    )
    ne = float(n_eff)
    assert 1.0 - 1e-3 <= ne <= pf.n_particles + 1e-3, ne
    print(f"[proc {pid}] ok: {n_global} global devices, n_eff={ne:.2f}",
          flush=True)


def main():
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
        return
    port = 49731
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(i), "2", str(port)],
            env=env,
        )
        for i in range(2)
    ]
    rc = [p.wait(timeout=300) for p in procs]
    assert rc == [0, 0], rc
    print("multihost smoke: PASS")


if __name__ == "__main__":
    main()
