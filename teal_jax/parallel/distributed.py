"""Multi-host initialization + mesh construction.

The reference launches one process per GPU with torchrun and initializes
NCCL (`gpt-fast/tp.py:36-51`). The JAX equivalent: one process per
host, `jax.distributed.initialize()`, and a global mesh spanning every
device; collectives (NCCL between GPUs) are placed by XLA from the
shardings, with no user-visible backend.

Exercised without accelerators by `experiments/multihost_dryrun.py`
(and tests/test_multihost.py): two real processes x 4 virtual CPU
devices each, gloo-backed `jax.distributed` handshake, a dp=2 x tp=4
global mesh, and a GSPMD decode step whose collectives cross the
process boundary — the DCN-analog of the 70B multi-host recipe.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from teal_jax.parallel.mesh import make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX. No-ops when single-process.

    Without a cluster environment JAX cannot auto-detect the
    arguments, so pass them (or set the env vars); env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID) override, mirroring the reference's
    LOCAL_RANK/LOCAL_WORLD_SIZE env protocol (tp.py:22-34).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int(
        "JAX_PROCESS_ID"
    )
    if num_processes in (None, 1) and coordinator_address is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_mesh(tp: Optional[int] = None, dp: int = 1):
    """Mesh over every addressable device across all hosts. For a 70B-class
    deployment: tp = GPUs per host (shards ride NVLink), dp = number of
    hosts (batch parallelism across the network)."""
    return make_mesh(tp=tp, dp=dp, devices=jax.devices())


def is_primary() -> bool:
    return jax.process_index() == 0
