"""Multi-host initialization and helpers (SURVEY.md §5.8, BASELINE.json:10).

The reference has no distributed execution (SURVEY.md §2 parallelism table).
The multi-host story here is exactly the single-host one: the SPMD
iteration in parallel/mesh.py is already written against a global mesh, so
scaling to several GPU hosts is

    1. every host runs the same program,
    2. ``jax.distributed.initialize`` wires the processes together; nothing
       on a GPU host announces a cluster, so the coordinator address
       (process 0's ``host:port``), the process count and each process's
       id are passed explicitly (``cli train --multihost --coordinator
       ... --num-processes ... --process-id ...``),
    3. the mesh is built over ``jax.devices()`` (now the GLOBAL device list),
    4. host-local data (nothing in this framework — envs live on device)
       needs no resharding; checkpoint shards are written by every process,
       logs and checkpoint metadata by process 0 only.

The learner's gradient ``pmean`` compiles to an all-reduce across devices
(NCCL on GPUs). tests/test_distributed.py runs a real 2-process cluster on
CPU (SURVEY.md §4 "Distributed without a cluster").
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up JAX's distributed runtime. No-op for single-process runs.

    Pass all three for a multi-process run: no GPU or CPU cluster
    announces its coordinator.
    """
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0


def barrier(name: str = "alphafive") -> None:
    """Block until every process reaches this point (multi-host sync)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def scale_for_processes(n: int) -> int:
    """Per-process share of a global count n (must divide evenly)."""
    p = jax.process_count()
    assert n % p == 0, f"global count {n} not divisible by {p} processes"
    return n // p
