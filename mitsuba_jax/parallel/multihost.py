"""Multi-host initialization helpers.

The reference scales across machines with a hand-rolled TCP render farm
(`RemoteWorker`/`StreamBackend`, sched_remote.cpp; `mtssrv` nodes,
mtssrv.cpp:90).  The JAX equivalent is a single SPMD job spanning all
hosts: `jax.distributed.initialize` joins the hosts, `jax.devices()` then
reports every device of every host, and the same `Mesh` + `shard_map`
code from parallel/mesh.py runs unchanged — XLA's collectives (NCCL on
GPUs) replace the socket protocol.

The functions are thin, standard wrappers kept separate so single-host
code does not import `jax.distributed`.
"""
from __future__ import annotations

import jax


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join this host to the multi-host job.  Pass the coordinator's
    address (host:port), the number of processes and this process's id
    unless the cluster environment provides them to JAX.  Must run before
    any other JAX call."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def pod_mesh():
    """A 1-D data-parallel mesh over every chip in the slice (all hosts).

    Rendering is embarrassingly parallel over pixels, so a flat pixel
    shard per chip is the right default even across hosts — the only
    cross-chip traffic is the final film/grad psum."""
    from mitsuba_jax.parallel.mesh import make_mesh

    return make_mesh(jax.devices())


def is_coordinator() -> bool:
    """True on process 0 — the host that should write output files
    (every host computes the full psum-reduced film, so only one
    should save it)."""
    return jax.process_index() == 0
