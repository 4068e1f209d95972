"""Canonical Huffman code generation and fast decode LUTs.

Equivalent of the reference's ``generate_codes`` (reference:
src/jpeg_scanner.cpp:438-448) plus a major upgrade over its bit-at-a-time
``get_next_symbol`` linear search (reference: src/jpeg_scanner.cpp:450-465):
we build a flat 16-bit peek LUT per table, so one table lookup decodes any
symbol (JPEG codes are at most 16 bits).  The same LUT feeds the NumPy
reference decoder and the C++ host fast path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from pim_jpeg_decoder_tpu.codec.header import HuffmanTableSpec, JpegError

MAX_CODE_LENGTH = 16


def canonical_codes(spec: HuffmanTableSpec) -> List[Tuple[int, int, int]]:
    """Assign canonical codes: returns [(code, length, symbol), ...].

    Standard JPEG canonical assignment: codes of each length are consecutive,
    and the first code of length L+1 is (last code of length L + 1) << 1.
    """
    out: List[Tuple[int, int, int]] = []
    code = 0
    si = 0
    for length in range(1, MAX_CODE_LENGTH + 1):
        n = int(spec.counts[length - 1])
        for _ in range(n):
            if code >= (1 << length):
                raise JpegError(
                    f"Invalid Huffman table: code overflow at length {length}")
            out.append((code, length, int(spec.symbols[si])))
            code += 1
            si += 1
        code <<= 1
    return out


@dataclasses.dataclass
class DecodeTable:
    """Flat peek-16 decode LUT.

    ``lut_symbol[peek16]`` is the decoded symbol and ``lut_length[peek16]``
    the number of bits it consumes; length 0 marks an invalid code.
    """
    lut_symbol: np.ndarray   # [65536] uint8
    lut_length: np.ndarray   # [65536] uint8
    # Encoder view (also used by tests): symbol -> (code, length)
    enc_code: np.ndarray     # [256] uint16
    enc_length: np.ndarray   # [256] uint8


@functools.lru_cache(maxsize=64)
def _build_decode_table_cached(counts: bytes, symbols: bytes) -> DecodeTable:
    spec = HuffmanTableSpec(
        0, 0,
        np.frombuffer(counts, np.uint8),
        np.frombuffer(symbols, np.uint8),
    )
    return _build_decode_table(spec)


def build_decode_table(spec: HuffmanTableSpec) -> DecodeTable:
    """Build (or fetch from cache) the peek-16 decode LUT for a table.

    Most corpora reuse the Annex K tables across every image, so the 64K
    fills amortize to zero (keyed by table content, not identity).
    """
    return _build_decode_table_cached(spec.counts.tobytes(),
                                      spec.symbols.tobytes())


def _build_decode_table(spec: HuffmanTableSpec) -> DecodeTable:
    lut_symbol = np.zeros(1 << MAX_CODE_LENGTH, dtype=np.uint8)
    lut_length = np.zeros(1 << MAX_CODE_LENGTH, dtype=np.uint8)
    enc_code = np.zeros(256, dtype=np.uint16)
    enc_length = np.zeros(256, dtype=np.uint8)
    for code, length, symbol in canonical_codes(spec):
        shift = MAX_CODE_LENGTH - length
        lo = code << shift
        hi = lo + (1 << shift)
        lut_symbol[lo:hi] = symbol
        lut_length[lo:hi] = length
        enc_code[symbol] = code
        enc_length[symbol] = length
    return DecodeTable(lut_symbol, lut_length, enc_code, enc_length)


def extend_signed(value: int, size: int) -> int:
    """JPEG signed-magnitude extension (ITU-T T.81 F.2.2.1 EXTEND).

    ``value`` is the raw `size`-bit magnitude field; returns the signed
    coefficient value.  Matches the reference's branch at
    reference: src/jpeg_scanner.cpp:484.
    """
    if size == 0:
        return 0
    if value < (1 << (size - 1)):
        return value - (1 << size) + 1
    return value
