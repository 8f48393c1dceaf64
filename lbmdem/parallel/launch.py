"""Multi-process launch (SURVEY.md SS5.8 distributed backend).

The reference is single-process/single-GPU; scaling beyond one host is
new work. Each host runs the same program; the coordinator address and
process ids come from arguments or the standard env vars (nothing
discovers them on a GPU cluster).

Typical multi-host usage:

    from lbmdem.parallel import init_distributed, make_mesh
    init_distributed("host0:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()               # all global devices
    sim = Simulation(cfg, disks, mesh=mesh)
    sim.run()

Each process then drives the same jitted sharded step; JAX executes it
SPMD over the global device set, with the ppermute halos and the force
psum lowered to the platform's collectives (NCCL on GPUs).
"""

from __future__ import annotations

import os
from typing import Optional

_INITIALIZED = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Arguments left out are taken from the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars when set. A single-process call
    (num_processes in (None-on-single-host, 1)) is valid and exercises
    the same code path the pod launch uses.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    import jax

    kw = {}
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address:
        kw["coordinator_address"] = coordinator_address
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if num_processes is not None:
        kw["num_processes"] = num_processes
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if process_id is None and env_pid:
        process_id = int(env_pid)
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)
    _INITIALIZED = True


def process_info():
    """(process_index, process_count, local_devices, global_devices)."""
    import jax

    return (
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )
