"""Device-mesh helpers (SURVEY.md §3 parallelism inventory).

The mesh + shard_map layer IS our distributed communication backend: XLA
lowers the collectives (`psum`, `all_gather`, `ppermute`) onto the devices'
interconnect (NCCL over NVLink between the GPUs of one host) — there is no
hand-written communication layer.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

PARTICLE_AXIS = "particles"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Multi-host bring-up (SURVEY.md §3 "Multi-host").

    Wraps `jax.distributed.initialize`. With no arguments it relies on a
    cluster environment jax auto-detects (SLURM / OpenMPI env vars) and
    fails without one; pass the coordinator address, process count and
    process id explicitly elsewhere, e.g. for two-process smoke tests:

        # terminal 1
        init_distributed("localhost:1234", 2, 0)
        # terminal 2
        init_distributed("localhost:1234", 2, 1)

    After this, `jax.devices()` spans all hosts: build the particle mesh as
    usual and shard_map's collectives span the processes. Data feeding
    stays host-local: each process feeds its own
    `jax.process_index()`-dependent shard of particles.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def make_particle_mesh(n_devices: int | None = None, axis: str = PARTICLE_AXIS) -> Mesh:
    """1-D mesh over the particle axis (data-parallel analog).

    Uses the first `n_devices` visible devices (all by default). For
    multi-host runs, call `jax.distributed.initialize()` first; `jax.devices()`
    then spans hosts and XLA routes the collectives automatically.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
