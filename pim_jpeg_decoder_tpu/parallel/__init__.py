"""Multi-device / multi-host scaling: mesh, shard_map decode, host sharding.

Replacement for the reference's UPMEM DpuSet communication layer
(reference: src/decoder_host.cpp:32,268,276-277,292,308-312): a
``jax.sharding.Mesh`` over devices with MCU tiles as the sharded axis
(SURVEY.md section 2, parallelism item 2), ``shard_map`` for the fused
decode, and whole-image sharding across hosts so only metadata crosses the
network
(SURVEY.md section 5, distributed backend).
"""

from pim_jpeg_decoder_tpu.parallel.mesh import make_mesh, MCU_AXIS
from pim_jpeg_decoder_tpu.parallel.sharding import decode_mcus_sharded

__all__ = ["make_mesh", "MCU_AXIS", "decode_mcus_sharded"]
