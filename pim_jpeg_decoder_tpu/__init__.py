"""pim_jpeg_decoder_tpu — a JPEG decode engine for NVIDIA GPUs, in JAX.

A from-scratch rebuild of the capabilities of the UPMEM-PIM JPEG decoder
(reference: jeun-990806/pim-jpeg-decoder):

- host marker scan + entropy decode (C++ fast path, NumPy fallback) feeding
- one fused device program (dequantize -> integer 8x8 IDCT -> chroma
  upsample -> YCbCr->RGB) in plain JAX, MCUs on the last axis,
- MCU sharding across devices via ``jax.sharding`` + ``shard_map``
  (replacing the reference's NUM_TASKLETS / MAX_MCU_PER_DPU DPU sharding),
- a producer/consumer pipeline overlapping host entropy decode with device
  execution (replacing the reference's two-thread batch queue,
  reference: src/decoder_host.cpp:35-38,364-365), and
- 24bpp bottom-up BMP output bit-exact against the NumPy oracle decoder.

Top-level API (lazy so that pure-CPU users don't pay the JAX import):
``TpuJpegDecoder``, ``decode_file``, ``decode_bytes``, ``decode_region``,
``decode_scaled``; batch/streaming (models.input_pipeline re-exports):
``decode_same_size_batch``, ``decode_same_size_batch_crops``,
``decode_batch_crops`` (mixed sizes), ``iter_decode_batches``,
``iter_decode_batch_crops``.
"""

from pim_jpeg_decoder_tpu.version import __version__

__all__ = ["__version__", "TpuJpegDecoder", "decode_file", "decode_bytes",
           "decode_region", "decode_scaled", "decode_same_size_batch",
           "decode_same_size_batch_crops", "decode_batch_crops",
           "iter_decode_batches", "iter_decode_batch_crops"]

_BATCH_API = ("decode_same_size_batch", "decode_same_size_batch_crops",
              "decode_batch_crops", "iter_decode_batches",
              "iter_decode_batch_crops")


def __getattr__(name):
    if name in ("TpuJpegDecoder", "decode_file", "decode_bytes",
                "decode_region", "decode_scaled"):
        from pim_jpeg_decoder_tpu.models import pipeline
        return getattr(pipeline, name)
    if name in _BATCH_API:
        from pim_jpeg_decoder_tpu.models import input_pipeline
        return getattr(input_pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
