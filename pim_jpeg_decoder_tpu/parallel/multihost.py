"""Multi-host corpus decode: whole-image sharding across processes.

The decode workload is embarrassingly parallel at image granularity, so the
multi-host design (SURVEY.md section 5, "distributed communication backend")
shards whole images per host: each process scans/entropy-decodes/launches
its own file shard against its local cards and writes its own BMPs — only
job metadata crosses the network.  This is how >=90% frames/s scaling efficiency is
achieved (BASELINE.md north star): there is no cross-host data dependency
at all.

``jax.distributed.initialize`` replaces the reference's process-global
``DpuSet::allocate(DPU_ALLOCATE_ALL)`` (reference: src/decoder_host.cpp:32).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import jax


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-process JAX (no-op when single-process).

    Proceeds when explicit arguments are given, when the standard JAX
    coordinator env var is set, or when a known cluster scheduler is
    detected (Slurm / Open MPI) — jax.distributed.initialize's
    own auto-detection handles those.  Plain single-host runs skip
    initialization; call once at startup on every host.
    """
    if num_processes is not None and num_processes <= 1:
        return

    def _env_gt1(var: str) -> bool:
        try:
            return int(os.environ.get(var, "1")) > 1
        except ValueError:
            return False

    # Markers that imply MULTI-process intent.  A bare SLURM_JOB_ID /
    # OMPI_COMM_WORLD_SIZE=1 (single task inside an allocation — common
    # interactive use) must NOT trigger initialize(), which would block
    # waiting for ranks that never join.
    multi_process_intent = (
        "JAX_COORDINATOR_ADDRESS" in os.environ
        or _env_gt1("SLURM_NTASKS")
        or _env_gt1("OMPI_COMM_WORLD_SIZE")
    )
    if (coordinator_address is None and num_processes is None
            and not multi_process_intent):
        # Plain single-host run: nothing to initialize.
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def partition_paths(paths: Sequence[str],
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[str]:
    """This host's shard of the corpus (strided assignment).

    Stride the list AFTER sorting by size (e.g. batching.sort_by_size) and
    per-host megapixel totals stay balanced — which is what the
    scaling-efficiency metric measures.
    """
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    return list(paths[process_index::process_count])


def local_chip_count() -> int:
    return jax.local_device_count()
