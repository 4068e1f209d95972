"""Progressive (SOF2) entropy decode: multi-scan successive approximation.

A capability EXTENSION over the reference: the reference carries progressive
block-decode paths (reference: src/jpeg_scanner.cpp:521-704 — DC first/
refine, AC first with EOB runs, AC refinement with correction bits) but its
single-scan reader errors at the second scan's markers, so progressive never
completes end-to-end (reference: src/jpeg_scanner.cpp:425-430).  This module
implements the full ITU-T T.81 G.2 decode over the multi-scan stream the
scanner now parses, accumulating per-component coefficient planes and
emitting the engine's standard ``[num_mcus, g, 64]`` transport layout — the
device decode path is identical to baseline from there on.

Semantics follow T.81 Annex G (the same scheme libjpeg implements), and
results are validated pixel-exact against PIL/libjpeg in tests.
"""

from __future__ import annotations

from typing import List

import numpy as np

from pim_jpeg_decoder_tpu.codec.entropy import BitReader
from pim_jpeg_decoder_tpu.codec.header import JpegError, JpegHeader, ScanData
from pim_jpeg_decoder_tpu.codec.huffman import (
    DecodeTable,
    build_decode_table,
    extend_signed,
)
from pim_jpeg_decoder_tpu.codec.tables import ZIGZAG


# The symbol decoder is shared with the baseline path (single source for
# the LUT protocol and its error contract).
from pim_jpeg_decoder_tpu.codec.entropy import _decode_symbol  # noqa: E402


class _ScanState:
    """Mutable per-scan decode state shared by the block procedures."""

    __slots__ = ("br", "eobrun", "preds")

    def __init__(self, br: BitReader, ncomp: int):
        self.br = br
        self.eobrun = 0
        self.preds = [0] * ncomp

    def reset(self, byte_offset: int, ncomp: int) -> None:
        self.br.seek_byte(byte_offset)
        self.eobrun = 0
        self.preds = [0] * ncomp


def _dc_first(st: _ScanState, block: np.ndarray, ci: int,
              dc: DecodeTable, al: int) -> None:
    t = _decode_symbol(st.br, dc)
    if t > 11:
        raise JpegError(f"Invalid DC coefficient size: {t}")
    diff = extend_signed(st.br.read_bits(t), t)
    st.preds[ci] += diff
    # int32 wrap on pathological predictors, matching the C++ path.
    block[0] = ((st.preds[ci] << al) + 0x80000000) % 0x100000000 - 0x80000000


def _dc_refine(st: _ScanState, block: np.ndarray, al: int) -> None:
    if st.br.read_bits(1):
        block[0] |= 1 << al


def _ac_first(st: _ScanState, block: np.ndarray,
              ac: DecodeTable, ss: int, se: int, al: int) -> None:
    if st.eobrun > 0:
        st.eobrun -= 1
        return
    k = ss
    while k <= se:
        sym = _decode_symbol(st.br, ac)
        r = sym >> 4
        s = sym & 0x0F
        if s == 0:
            if r != 15:
                st.eobrun = (1 << r) - 1
                if r:
                    st.eobrun += st.br.read_bits(r)
                return
            k += 16           # ZRL
            continue
        k += r
        if k > se:
            raise JpegError("Decoded AC coefficient index out of range")
        block[k] = extend_signed(st.br.read_bits(s), s) << al
        k += 1


def _ac_refine(st: _ScanState, block: np.ndarray,
               ac: DecodeTable, ss: int, se: int, al: int) -> None:
    """AC successive-approximation refinement (T.81 G.1.2.3 / G.2).

    Equivalent of the reference's correction-bit path
    (reference: src/jpeg_scanner.cpp:607-703).
    """
    br = st.br
    p1 = 1 << al
    m1 = -1 << al
    k = ss

    def correct(idx: int) -> None:
        # One correction bit for a coefficient that is already nonzero.
        if br.read_bits(1) and (block[idx] & p1) == 0:
            block[idx] += p1 if block[idx] >= 0 else m1

    if st.eobrun == 0:
        while k <= se:
            sym = _decode_symbol(br, ac)
            r = sym >> 4
            s = sym & 0x0F
            newval = 0
            if s == 0:
                if r != 15:
                    # Unlike AC-first, the EOB run INCLUDES this block: its
                    # remaining nonzero coefficients still consume
                    # correction bits below; the tail decrements the run.
                    st.eobrun = 1 << r
                    if r:
                        st.eobrun += br.read_bits(r)
                    break
                # ZRL: skip 16 zero-history positions, correcting nonzeros.
            else:
                if s != 1:
                    raise JpegError(
                        f"Invalid AC refinement symbol 0x{sym:02X}")
                newval = p1 if br.read_bits(1) else m1
            # Advance past r zero-history coefficients (nonzero positions
            # consume correction bits and do not count toward the run).
            while k <= se:
                if block[k] != 0:
                    correct(k)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if newval and k <= se:
                block[k] = newval
            k += 1

    if st.eobrun > 0:
        while k <= se:
            if block[k] != 0:
                correct(k)
            k += 1
        st.eobrun -= 1


def _decode_one_scan(header: JpegHeader, scan: ScanData,
                     planes: List[np.ndarray]) -> None:
    """Decode one scan into the (zigzag-order) coefficient planes."""
    spec = scan.spec
    ss, se = spec.start_of_selection, spec.end_of_selection
    ah, al = spec.successive_high, spec.successive_low

    dc_tables = [build_decode_table(s) if s is not None else None
                 for s in scan.dc_specs]
    ac_tables = [build_decode_table(s) if s is not None else None
                 for s in scan.ac_specs]

    br = BitReader(scan.entropy_bytes)
    st = _ScanState(br, header.ncomp)
    ri = scan.restart_interval
    offsets = scan.segment_offsets
    seg = 0

    def maybe_restart(unit: int) -> None:
        nonlocal seg
        if ri and unit and unit % ri == 0:
            seg += 1
            if seg >= len(offsets):
                raise JpegError(
                    f"Missing restart segment {seg} (have {len(offsets)})")
            st.reset(offsets[seg], header.ncomp)

    if scan.interleaved or ss == 0 and len(scan.component_indices) == header.ncomp:
        # Interleaved scan: MCU walk over the padded grid (DC bands only,
        # per the SOS validation).
        slots = []
        for i, ci in enumerate(scan.component_indices):
            c = header.components[ci]
            for qv in range(c.v):
                for qh in range(c.h):
                    slots.append((i, ci, qv, qh))
        mcu_cols = header.mcu_cols
        for m in range(header.num_mcus):
            maybe_restart(m)
            my, mx = divmod(m, mcu_cols)
            for i, ci, qv, qh in slots:
                c = header.components[ci]
                block = planes[ci][my * c.v + qv, mx * c.h + qh]
                if ah == 0:
                    _dc_first(st, block, ci, dc_tables[i], al)
                else:
                    _dc_refine(st, block, al)
    else:
        # Non-interleaved scan: raster over the component's UNPADDED block
        # grid (T.81 A.2.2); restart interval counts blocks here.
        i = 0
        ci = scan.component_indices[0]
        bw, bh = header.comp_blocks(ci)
        for b in range(bw * bh):
            maybe_restart(b)
            by, bx = divmod(b, bw)
            block = planes[ci][by, bx]
            if ss == 0:
                if ah == 0:
                    _dc_first(st, block, ci, dc_tables[i], al)
                else:
                    _dc_refine(st, block, al)
            else:
                if ah == 0:
                    _ac_first(st, block, ac_tables[i], ss, se, al)
                else:
                    _ac_refine(st, block, ac_tables[i], ss, se, al)


def decode_progressive(header: JpegHeader, use_native: bool = True,
                       threads: int = 1) -> np.ndarray:
    """Decode all scans of a progressive JPEG.

    Returns coefficients ``[num_mcus, g, 64]`` int16 in natural order —
    identical transport layout to the baseline decoders, so everything
    downstream (fused kernel, oracle reconstruction) is shared.

    Per-scan decode runs in C++ when available (``use_native``), with this
    module's Python implementation as the semantic reference/fallback.
    ``threads > 1`` fans the per-component scan chains across cores
    (byte-identical output; see binding.decode_progressive_image_cpp).
    """
    if not header.progressive:
        raise JpegError("decode_progressive requires a progressive frame")

    if use_native:
        from pim_jpeg_decoder_tpu.native import native_available
        if native_available():
            # Production path: ONE native call decodes every scan and
            # assembles the transport (binding.decode_progressive_image_cpp);
            # the per-scan loop below is the semantic reference, kept for
            # fallback and differential tests.
            from pim_jpeg_decoder_tpu.native.binding import (
                decode_progressive_image_cpp,
            )
            return decode_progressive_image_cpp(header, threads=threads)

    # Zigzag-order coefficient planes, padded to the MCU grid, in ONE flat
    # buffer (the C++ path indexes it via per-component offsets; the Python
    # path uses reshaped views of the same memory).
    sizes = []
    for ci in range(header.ncomp):
        bwp, bhp = header.comp_blocks_padded(ci)
        sizes.append((bhp, bwp))
    comp_offset = np.zeros(3, np.int64)
    total = 0
    for ci, (bhp, bwp) in enumerate(sizes):
        comp_offset[ci] = total * 64
        total += bhp * bwp
    buf = np.zeros(total * 64, np.int32)
    planes = [
        buf[int(comp_offset[ci]):int(comp_offset[ci]) + bhp * bwp * 64]
        .reshape(bhp, bwp, 64)
        for ci, (bhp, bwp) in enumerate(sizes)
    ]

    for scan in header.scans:
        _decode_one_scan(header, scan, planes)

    # Assemble the MCU-group transport layout (de-zigzag here).
    slots = header.slot_components()
    out = np.zeros((header.num_mcus, len(slots), 64), np.int16)
    for s, (ci, qv, qh) in enumerate(slots):
        c = header.components[ci]
        view = planes[ci][qv::c.v, qh::c.h].reshape(header.num_mcus, 64)
        out[:, s, ZIGZAG] = np.clip(view, -32768, 32767)
    return out
