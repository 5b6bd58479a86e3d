"""Multi-process bootstrap — the comm-backend component SURVEY §2.7 / §5
names (the reference is single-GPU, App.cu:414-468).

One process drives all the devices of one machine; several machines join
through `jax.distributed.initialize`, after which the row and tile meshes of
parallel.sharded / parallel.tiled span every process's devices. XLA inserts
the collectives from the shardings (NCCL on GPUs); nothing here speaks
NCCL/MPI.
"""

from __future__ import annotations

import os

import jax

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Bring up the JAX distributed runtime (idempotent).

    With no arguments, reads the standard env vars (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID). Single-process runs (no coordinator
    configured) are a no-op. Returns the process count.
    """
    global _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return 1  # single host — nothing to rendezvous

    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    return jax.process_count()
