"""Multi-host runtime initialization.

The reference's only "distribution" is DDS discovery between nine local
processes (SURVEY.md §5). The equivalent here is the JAX multi-host
runtime: every host runs the same program, ``jax.distributed.initialize``
wires the hosts into one global device mesh, and GSPMD partitions the
scenario bank across all devices — collectives ride NVLink between the
GPUs of a host and the network across hosts with no further code changes
(the mesh layer in ros2_mpc_jax.parallel.mesh is already
global-device-aware). One host drives all of its GPUs from one process.

On a single host (or under tests) initialization is a no-op.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger("distributed")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize the multi-host runtime if a cluster is configured.

    Resolution order: explicit args > JAX_COORDINATOR_ADDRESS env (with
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) > single-process no-op. A GPU
    cluster has no metadata server to ask, so the coordinator address,
    process count and process id are always given.

    Returns a summary dict {initialized, process_index, process_count,
    local_devices, global_devices}.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    initialized = False
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        initialized = True

    info = {
        "initialized": initialized,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
    log.info("distributed runtime: %s", info)
    return info
