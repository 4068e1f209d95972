"""The JPEG decode pipeline — scan, entropy-decode, device decode, raster.

The "flagship model" of this framework: a jittable device program (the fused
decode from :mod:`pim_jpeg_decoder_tpu.ops.decode_kernel`) wrapped in
host stages that mirror the reference's pipeline end to end:

  scan_jpeg (marker parse)      <- reference src/jpeg_scanner.cpp:345
  entropy decode                <- reference src/jpeg_scanner.cpp:707 (host thread)
  pack MCU batch + quant pool   <- reference decoder_host.cpp:101-211 (mcu_prepare)
  device decode (fused kernel)  <- reference decoder_dpu.c (3 DPU phases, fused)
  raster assembly + BMP         <- reference bmp_writer.cpp:19

Single-image convenience APIs here; multi-image batching, the producer/
consumer overlap and sharding live in :mod:`pim_jpeg_decoder_tpu.runtime`
and :mod:`pim_jpeg_decoder_tpu.parallel`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from pim_jpeg_decoder_tpu.codec.header import JpegHeader
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.io.bmp import write_bmp
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import (
    LANE_TILE,
    decode_mcus,
    pad_mcus,
)


def _pad_for_mesh(num_mcus: int, lane_tile: int, mesh) -> int:
    """Transport padding: each chip's shard must be whole lane tiles."""
    unit = lane_tile if mesh is None else mesh.devices.size * lane_tile
    return pad_mcus(num_mcus, unit)


def _device_decode(padded, qidx, qpool, mode: S.ModeSpec, lane_tile: int,
                   mesh, **kw) -> np.ndarray:
    """Run the fused kernel single-device, or sharded over the MCU axis
    when a mesh is given (same program per chip; no collectives — see
    parallel/sharding.py).  Single-image latency paths accept ``mesh=``
    so a large image's MCU grid can split across local chips, mirroring
    the reference's many-DPUs-per-image scatter (reference:
    src/decoder_host.cpp:125-128)."""
    if mesh is None:
        return np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                      lane_tile=lane_tile, **kw))
    from pim_jpeg_decoder_tpu.parallel.sharding import decode_mcus_sharded
    return np.asarray(decode_mcus_sharded(padded, qidx, qpool, mode,
                                          mesh=mesh, lane_tile=lane_tile,
                                          **kw))


def entropy_decode(header: JpegHeader, out=None,
                   threads: int = 1) -> np.ndarray:
    """Entropy-decode via the native C++ fast path, NumPy fallback.

    Progressive frames route through the multi-scan successive-approximation
    decoder; both paths emit ``[num_mcus, g, 64]`` int16 natural-order
    coefficients, so the device pipeline is shared.  ``out`` (optional,
    caller-zeroed) receives the coefficients in place — the ML batch path
    passes transport-buffer slices to skip a copy.  ``threads > 1`` fans
    restart segments of a baseline DRI image across cores (the segment
    entry points the reference strips without exploiting, reference:
    src/jpeg_scanner.cpp:423), or a progressive image's per-component
    scan chains; ignored for baseline non-DRI streams.
    """
    if header.progressive:
        from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive
        coeffs = decode_progressive(header, threads=threads)
        if out is not None:
            out[...] = coeffs
            return out
        return coeffs
    from pim_jpeg_decoder_tpu.native import decode_scan_native
    return decode_scan_native(header, out=out, threads=threads)


def build_qpool(headers: Sequence[JpegHeader], mode: S.ModeSpec) -> np.ndarray:
    """Per-image, per-slot quantizer rows: ``[num_images, g, 64]`` float32."""
    qpool = np.zeros((len(headers), mode.g, 64), dtype=np.float32)
    for i, header in enumerate(headers):
        for s, (ci, _, _) in enumerate(header.slot_components()):
            qpool[i, s] = header.component_qt(header.components[ci])
    return qpool


def assemble_raster_slots(header: JpegHeader, slot_rgb: np.ndarray) -> np.ndarray:
    """Kernel output ``[num_mcus, luma_slots, 64, 3]`` -> ``[H, W, 3]``.

    Pure layout: MCU raster grid (gh, gw), luma slots (V, H) within each MCU,
    8x8 pixels within each slot.  Replaces the reference's per-pixel inverse
    scatter walk (reference: src/bmp_writer.cpp:51-60) with one vectorized
    reshape/transpose.
    """
    mode = S.mode_for(header.mode_key)
    gh, gw = header.mcu_rows, header.mcu_cols
    v, h = mode.v, mode.h
    # Kernel-native slot pixel order is COLUMN-major: index = px*8 + py.
    img = (
        slot_rgb[: gh * gw]
        .reshape(gh, gw, v, h, 8, 8, 3)
        .transpose(0, 2, 5, 1, 3, 4, 6)
        .reshape(gh * v * 8, gw * h * 8, 3)
    )
    return np.ascontiguousarray(img[: header.height, : header.width])


def assemble_raster_raw(header: JpegHeader, raw_rgb: np.ndarray,
                        mcu_off: int = 0) -> np.ndarray:
    """Kernel-native output ``[3, luma_slots, 64, M]`` -> ``[H, W, 3]``.

    Same single vectorized pass as :func:`assemble_raster_slots`, consuming
    the raw (transpose-free, ~4x faster on device) kernel layout.
    ``mcu_off``: the image's MCU offset within a (padded, multi-image)
    batch buffer — pass the FULL buffer, not a slice, so the C++ fast
    path's contiguity requirement holds.
    """
    return assemble_raster_raw_scaled(header, raw_rgb, 1, mcu_off)


def assemble_raster_raw_scaled(header: JpegHeader, raw_rgb: np.ndarray,
                               scale: int, mcu_off: int = 0) -> np.ndarray:
    """Scaled-decode kernel output ``[3, luma_slots, nn, M]`` ->
    ``[ceil(H/scale), ceil(W/scale), 3]`` (nn = (8/scale)^2); ``mcu_off``
    as in :func:`assemble_raster_raw`."""
    mode = S.mode_for(header.mode_key)
    gh, gw = header.mcu_rows, header.mcu_cols
    v, h = mode.v, mode.h
    n = 8 // scale
    out_h = -(-header.height // scale)
    out_w = -(-header.width // scale)
    # C++ fast path: one pass near the pixel-scatter floor (~4x the NumPy
    # transpose chain on one core); byte-identical (equality-tested).
    try:
        from pim_jpeg_decoder_tpu.native.binding import raster_rgb_cpp
        out = raster_rgb_cpp(raw_rgb, v, h, n, gh, gw, out_h, out_w,
                             mcu_off=mcu_off)
        if out is not None:
            return out
    except ImportError:
        pass
    # Kernel-native slot pixel order is COLUMN-major: reshape as (px, py).
    img = (
        raw_rgb[..., mcu_off:mcu_off + gh * gw]
        .reshape(3, v, h, n, n, gh, gw)
        .transpose(5, 1, 4, 6, 2, 3, 0)
        .reshape(gh * v * n, gw * h * n, 3)
    )
    return np.ascontiguousarray(img[:out_h, :out_w])


def assemble_raster_ycbcr(header: JpegHeader, planes: np.ndarray,
                          mcu_off: int = 0) -> np.ndarray:
    """Wire-optimal YCbCr kernel output ``[g, 64, m_total]`` -> ``[H, W, 3]``.

    Finishes the decode on the host: nearest-neighbor chroma upsample +
    fixed-point BT.601 with EXACTLY the integer spec of ops/specs.py, so the
    result is bit-identical to the fused RGB kernel path.  Dispatches to the
    C++ fast path (native/entropy.cpp:pjt_ycbcr_to_rgb) when available.
    """
    mode = S.mode_for(header.mode_key)
    gh, gw = header.mcu_rows, header.mcu_cols

    from pim_jpeg_decoder_tpu.native import native_available
    if native_available():
        from pim_jpeg_decoder_tpu.native.binding import ycbcr_to_rgb_cpp
        return ycbcr_to_rgb_cpp(planes, mcu_off, mode.v, mode.h, mode.ncomp,
                                gh, gw, header.height, header.width)

    # NumPy fallback: same integer spec via the oracle color primitives.
    m = gh * gw
    stored = planes[:, :, mcu_off:mcu_off + m]              # [g, 64, m] u8
    if mode.ncomp == 1:
        y = stored[0].T                                     # [m, 64] u8
        slots = np.repeat(y[:, None, :, None], 3, axis=3)   # [m, 1, 64, 3]
        return assemble_raster_slots(header, slots)

    from pim_jpeg_decoder_tpu.oracle.color import chroma_subblock, ycbcr_to_rgb
    centered = stored.astype(np.int32) - 128                # spec sample range
    # Wire planes are column-major (px*8 + py); swap to (py, px) blocks.
    ps = (centered.transpose(2, 0, 1).reshape(m, mode.g, 8, 8)
          .swapaxes(-1, -2))
    gy = mode.luma_slots
    slots = np.empty((m, gy, 64, 3), np.uint8)
    for s in range(gy):
        qv, qh = mode.luma_slot_pos(s)
        cb = chroma_subblock(ps[:, gy], qv, qh, mode.v, mode.h)
        cr = chroma_subblock(ps[:, gy + 1], qv, qh, mode.v, mode.h)
        rgb = ycbcr_to_rgb(ps[:, s], cb, cr)                # [m, py, px, 3]
        slots[:, s] = rgb.swapaxes(1, 2).reshape(m, 64, 3)  # p-major
    return assemble_raster_slots(header, slots)


@dataclasses.dataclass
class DecodeResult:
    rgb: np.ndarray
    header: JpegHeader


class TpuJpegDecoder:
    """Single-stream decoder: one image (or a same-mode list) per device call.

    For high-throughput multi-image decoding use
    :class:`pim_jpeg_decoder_tpu.runtime.engine.DecodeEngine`, which packs
    images into fixed-size device batches and overlaps host entropy decode
    with device execution.
    """

    def __init__(self, lane_tile: int = LANE_TILE, transport: str = "auto",
                 mesh=None):
        if transport not in ("auto", "rgb", "ycbcr"):
            raise ValueError(
                f"transport must be auto/rgb/ycbcr, got {transport!r}")
        self.lane_tile = lane_tile
        self.transport = transport
        self.mesh = mesh

    def decode(self, data: bytes) -> DecodeResult:
        header = scan_jpeg(data)
        coeffs = entropy_decode(header)
        mode = S.mode_for(header.mode_key)

        m_pad = _pad_for_mesh(header.num_mcus, self.lane_tile, self.mesh)
        padded = np.zeros((m_pad, mode.g, 64), dtype=np.int16)
        padded[: header.num_mcus] = coeffs
        qidx = np.zeros(m_pad, dtype=np.int32)
        qpool = build_qpool([header], mode)

        # Same wire-bytes policy as the engine: fetch subsampled YCbCr
        # planes when that reduces D2H, finish upsample+color on the host
        # (bit-identical; see assemble_raster_ycbcr).
        ycbcr = (self.transport == "ycbcr"
                 or (self.transport == "auto" and mode.ycbcr_saves_bytes))
        if ycbcr:
            planes = _device_decode(padded, qidx, qpool, mode,
                                    self.lane_tile, self.mesh, ycbcr=True)
            return DecodeResult(assemble_raster_ycbcr(header, planes),
                                header)
        raw_rgb = _device_decode(padded, qidx, qpool, mode, self.lane_tile,
                                 self.mesh, raw=True)
        return DecodeResult(assemble_raster_raw(header, raw_rgb), header)

    def decode_batch(self, blobs: Sequence[bytes]) -> List[DecodeResult]:
        return [self.decode(b) for b in blobs]


_DEFAULT: Optional[TpuJpegDecoder] = None


def _default_decoder() -> TpuJpegDecoder:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TpuJpegDecoder()
    return _DEFAULT


def decode_bytes(data: bytes) -> np.ndarray:
    """Decode one JPEG byte string to an ``[H, W, 3]`` uint8 RGB array."""
    return _default_decoder().decode(data).rgb


def decode_scaled(data: bytes, scale: int,
                  lane_tile: int = LANE_TILE, mesh=None) -> np.ndarray:
    """Scaled decode: ``[ceil(H/scale), ceil(W/scale), 3]`` for scale 2/4/8.

    Reduced (8/scale)-point IDCT of the top-left frequency sub-block — the
    libjpeg ``scale_denom`` capability on the device: device work and D2H
    shrink by ~scale^2, the natural fit for ML input pipelines that resize
    anyway.  scale=1 is a full decode.  ``mesh=`` shards the MCU grid
    across local chips (bit-identical; tested).
    """
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    if scale == 1:
        return TpuJpegDecoder(lane_tile, mesh=mesh).decode(data).rgb \
            if mesh is not None else decode_bytes(data)
    header = scan_jpeg(data)
    coeffs = entropy_decode(header)
    mode = S.mode_for(header.mode_key)

    m_pad = _pad_for_mesh(header.num_mcus, lane_tile, mesh)
    padded = np.zeros((m_pad, mode.g, 64), np.int16)
    padded[: header.num_mcus] = coeffs
    qidx = np.zeros(m_pad, np.int32)
    qpool = build_qpool([header], mode)

    raw = _device_decode(padded, qidx, qpool, mode, lane_tile, mesh,
                         raw=True, scale=scale)
    return assemble_raster_raw_scaled(header, raw, scale)


def decode_region(data: bytes, y0: int, x0: int, height: int, width: int,
                  lane_tile: int = LANE_TILE, mesh=None) -> np.ndarray:
    """Decode only the crop box ``[y0:y0+height, x0:x0+width]``.

    Entropy decode is inherently whole-scan (serial bitstream), but device
    work and transfer shrink to the MCU sub-grid covering the box — for an
    ImageNet-style random crop that is a ~3-5x cut.  Pixels are bit-identical
    to the same slice of a full decode (tested).  ``mesh=`` shards the
    sub-grid's MCUs across local chips.
    """
    header = scan_jpeg(data)
    if not (0 <= y0 and 0 <= x0 and height > 0 and width > 0
            and y0 + height <= header.height and x0 + width <= header.width):
        raise ValueError(
            f"crop [{y0}:{y0 + height}, {x0}:{x0 + width}] outside "
            f"{header.height}x{header.width}")
    coeffs = entropy_decode(header)
    mode = S.mode_for(header.mode_key)
    px_h, px_w = 8 * mode.v, 8 * mode.h

    r0, c0 = y0 // px_h, x0 // px_w
    r1 = -(-(y0 + height) // px_h)
    c1 = -(-(x0 + width) // px_w)
    cols = header.mcu_cols
    grid = (coeffs[: header.num_mcus]
            .reshape(header.mcu_rows, cols, mode.g, 64))
    sub = np.ascontiguousarray(grid[r0:r1, c0:c1]).reshape(-1, mode.g, 64)

    # A sub-header describing just the MCU sub-grid (geometry properties
    # derive from width/height, so replace() keeps them consistent).
    sub_header = dataclasses.replace(header, height=(r1 - r0) * px_h,
                                     width=(c1 - c0) * px_w)

    m_pad = _pad_for_mesh(sub.shape[0], lane_tile, mesh)
    padded = np.zeros((m_pad, mode.g, 64), np.int16)
    padded[: sub.shape[0]] = sub
    qidx = np.zeros(m_pad, np.int32)
    qpool = build_qpool([header], mode)

    if mode.ycbcr_saves_bytes:
        planes = _device_decode(padded, qidx, qpool, mode, lane_tile, mesh,
                                ycbcr=True)
        raster = assemble_raster_ycbcr(sub_header, planes)
    else:
        raw = _device_decode(padded, qidx, qpool, mode, lane_tile, mesh,
                             raw=True)
        raster = assemble_raster_raw(sub_header, raw)
    oy, ox = y0 - r0 * px_h, x0 - c0 * px_w
    return np.ascontiguousarray(raster[oy:oy + height, ox:ox + width])


def output_path(input_path: str) -> str:
    """BMP output naming rule of the reference: replace the extension with
    .bmp, or append .bmp if there is none (reference: src/decoder_host.cpp:330)."""
    stem, ext = os.path.splitext(input_path)
    return (stem if ext else input_path) + ".bmp"


def decode_file(path: str, out_path: Optional[str] = None) -> str:
    """Decode a JPEG file and write the BMP next to it; returns the BMP path."""
    with open(path, "rb") as f:
        data = f.read()
    rgb = decode_bytes(data)
    out = out_path or output_path(path)
    write_bmp(out, rgb)
    return out
