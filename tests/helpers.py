"""Shared test staging helpers (the device-transport contract, defined
once instead of per-file copies)."""

import numpy as np

from pim_jpeg_decoder_tpu.models.pipeline import build_qpool
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import pad_mcus


def stage_single(header, coeffs, lane_tile=128):
    """Single-image device-transport staging: ``[num_mcus, g, 64]``
    coefficients -> lane-padded ``(padded, qidx, qpool, mode)``."""
    mode = S.mode_for(header.mode_key)
    m_pad = pad_mcus(header.num_mcus, lane_tile)
    padded = np.zeros((m_pad, mode.g, 64), np.int16)
    padded[: header.num_mcus] = coeffs
    qidx = np.zeros(m_pad, np.int32)
    return padded, qidx, build_qpool([header], mode), mode


def widen_dqt(data: bytes) -> bytes:
    """Rewrite every DQT segment as 16-bit (Pq=1): each table keeps its
    entries, except every 7th natural-order entry becomes 65535 (the
    largest 16-bit quantizer)."""
    import struct

    from pim_jpeg_decoder_tpu.codec import markers as M
    from pim_jpeg_decoder_tpu.codec.tables import ZIGZAG

    out, pos = bytearray(data[:2]), 2
    big = ZIGZAG % 7 == 3          # per stored (zigzag) slot
    while pos < len(data):
        marker, length = struct.unpack_from(">HH", data, pos)
        body = data[pos + 4:pos + 2 + length]
        if marker == M.SOS:
            out += data[pos:]
            break
        if marker == M.DQT:
            new, i = bytearray(), 0
            while i < len(body):
                tq, step = body[i] & 0x0F, 129 if body[i] >> 4 else 65
                vals = (np.frombuffer(body[i + 1:i + step], ">u2")
                        if body[i] >> 4 else
                        np.frombuffer(body[i + 1:i + step], np.uint8))
                vals = np.where(big, 65535, vals.astype(np.int64)).astype(">u2")
                new += bytes([0x10 | tq]) + vals.tobytes()
                i += step
            out += struct.pack(">HH", M.DQT, len(new) + 2) + new
        else:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out)
