"""Device mesh construction.

The decode workload has one natural device axis: MCU tiles (inter-device data
parallelism — the equivalent of the reference's inter-DPU MCU sharding,
``MAX_MCU_PER_DPU`` chunks over consecutive DPUs,
reference: src/decoder_host.cpp:125-128).  A 1-D mesh over all local chips
is therefore the default; ``DPU_ALLOCATE_ALL``'s equivalent is simply
``jax.devices()`` (reference: src/decoder_host.cpp:32).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

# The sharded axis name: MCU tiles across chips.
MCU_AXIS = "mcu"


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 1-D mesh over ``num_devices`` chips (default: all local).

    Local devices only: in a multi-process (multi-host) run each process
    shards MCU tiles over its OWN chips — images are whole-host-sharded
    (parallel/multihost.py), so a process must never build a mesh spanning
    other processes' devices from host data.
    """
    import numpy as np
    if devices is None:
        devices = jax.local_devices()
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (MCU_AXIS,))
