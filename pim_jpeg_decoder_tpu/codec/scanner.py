"""JPEG marker scanner: bytes -> :class:`JpegHeader`.

Equivalent of the reference's marker parsers and top-level scanner
(reference: src/jpeg_scanner.cpp:6-343 ``read_*`` parsers and
src/jpeg_scanner.cpp:345-436 ``read_JPEG``), with the same validation
surface:

- 8-bit sample precision only (reference: src/jpeg_scanner.cpp:197),
- 1 or 3 components; CMYK (4 components) and YIQ-style component ids are
  rejected (reference: src/jpeg_scanner.cpp:216,230),
- luma sampling factors in {1,2}x{1,2}; chroma must be 1x1
  (reference: src/jpeg_scanner.cpp:250-270),
- zero-based component-id normalization (reference: src/jpeg_scanner.cpp:228-229),
- DQT 8/16-bit entries de-zigzagged on load (reference: src/jpeg_scanner.cpp:306,311),
- DHT canonical counts with <= 162 symbols (reference: src/jpeg_scanner.cpp:140-185),
- baseline/progressive SOS spectral-selection rules (reference: src/jpeg_scanner.cpp:79-106),
- entropy scan: 0xFF00 de-stuffing, RSTn stripping, 0xFF fill tolerance, and
  an error on any other marker mid-scan (reference: src/jpeg_scanner.cpp:405-433).

Improvements over the reference (deliberate, see SURVEY.md section 2/C10):
restart-segment *offsets* are recorded during the entropy scan so the decode
stage can treat each restart interval as an independent bitstream entry
point, and progressive (SOF2) streams are FULLY parsed — every scan's
entropy data and table snapshots are collected so codec/progressive.py can
decode multi-scan successive approximation end to end (the reference's
scanner errors at the second scan's markers and can never complete
progressive, reference: src/jpeg_scanner.cpp:425-430).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pim_jpeg_decoder_tpu.codec import markers as M
from pim_jpeg_decoder_tpu.codec.header import (
    Component,
    HuffmanTableSpec,
    JpegError,
    JpegHeader,
    QuantTable,
    ScanData,
    ScanSpec,
    UnsupportedJpegError,
)
from pim_jpeg_decoder_tpu.codec.tables import ZIGZAG


class _Cursor:
    """Byte cursor with big-endian helpers over the raw JPEG bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        if self.pos >= len(self.data):
            raise JpegError("Unexpected end of JPEG data")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise JpegError("Unexpected end of JPEG data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _read_dqt(cur: _Cursor, header: JpegHeader) -> None:
    """DQT segment: one or more tables, 8- or 16-bit, de-zigzagged on load."""
    length = cur.u16() - 2
    end = cur.pos + length
    while cur.pos < end:
        info = cur.u8()
        table_id = info & 0x0F
        precision = info >> 4
        if table_id > 3:
            raise JpegError(f"Invalid quantization table ID: {table_id}")
        if precision > 1:
            raise JpegError(f"Invalid quantization table precision: {precision}")
        values = np.zeros(64, dtype=np.uint16)
        if precision == 1:
            raw = np.frombuffer(cur.take(128), dtype=">u2").astype(np.uint16)
        else:
            raw = np.frombuffer(cur.take(64), dtype=np.uint8).astype(np.uint16)
        values[ZIGZAG] = raw  # store in natural order
        header.quant_tables[table_id] = QuantTable(table_id, precision, values)
    if cur.pos != end:
        raise JpegError("DQT segment length mismatch")


def _read_dht(cur: _Cursor, header: JpegHeader) -> None:
    """DHT segment: canonical Huffman table definitions."""
    length = cur.u16() - 2
    end = cur.pos + length
    while cur.pos < end:
        info = cur.u8()
        table_id = info & 0x0F
        table_class = info >> 4
        if table_id > 3:
            raise JpegError(f"Invalid Huffman table ID: {table_id}")
        if table_class > 1:
            raise JpegError(f"Invalid Huffman table class: {table_class}")
        counts = np.frombuffer(cur.take(16), dtype=np.uint8).copy()
        total = int(counts.sum())
        if total > 162:
            raise JpegError(f"Huffman table has too many symbols: {total}")
        symbols = np.frombuffer(cur.take(total), dtype=np.uint8).copy()
        spec = HuffmanTableSpec(table_id, table_class, counts, symbols)
        (header.ac_tables if table_class else header.dc_tables)[table_id] = spec
    if cur.pos != end:
        raise JpegError("DHT segment length mismatch")


def _read_sof(cur: _Cursor, header: JpegHeader, marker: int) -> None:
    """SOF0/SOF2 frame header with the reference's validation rules."""
    if header.components:
        raise JpegError("Multiple SOF markers in one JPEG")
    header.progressive = marker == M.SOF2
    length = cur.u16() - 2
    start = cur.pos

    header.precision = cur.u8()
    if header.precision != 8:
        raise UnsupportedJpegError(
            f"Invalid precision: {header.precision} (only 8-bit supported)")
    header.height = cur.u16()
    header.width = cur.u16()
    if header.height == 0:
        # T.81 B.2.5: height 0 defers the line count to a DNL segment
        # after the first scan — well-formed but unsupported here (the
        # DNL segment itself is skipped at :415).
        raise UnsupportedJpegError(
            "Height 0 (DNL-deferred number of lines) not supported")
    if header.width == 0:
        raise JpegError("Invalid JPEG dimensions: 0")

    ncomp = cur.u8()
    if ncomp == 4:
        raise UnsupportedJpegError("CMYK color mode not supported")
    if ncomp not in (1, 3):
        raise JpegError(f"Invalid number of components: {ncomp}")

    comp_ids: List[int] = []
    comps: List[Component] = []
    for _ in range(ncomp):
        cid = cur.u8()
        sampling = cur.u8()
        qt_id = cur.u8()
        comp_ids.append(cid)
        comps.append(Component(cid, sampling >> 4, sampling & 0x0F, qt_id))

    # Zero-based component-id fixup: some encoders emit ids 0..2 instead of
    # 1..3 (reference: src/jpeg_scanner.cpp:228-229).
    if comp_ids and comp_ids[0] == 0:
        header.zero_based_ids = True
        for c in comps:
            c.component_id += 1
        comp_ids = [c.component_id for c in comps]
    if any(cid in (4, 5) for cid in comp_ids):
        raise UnsupportedJpegError("YIQ color mode not supported")
    if any(cid == 0 or cid > 3 for cid in comp_ids):
        raise JpegError(f"Invalid component IDs: {comp_ids}")
    if len(set(comp_ids)) != len(comp_ids):
        raise JpegError(f"Duplicate component IDs: {comp_ids}")

    for i, c in enumerate(comps):
        if c.qt_id > 3:
            raise JpegError(f"Invalid quantization table ID in frame components: {c.qt_id}")
        if i == 0:
            if c.h not in (1, 2) or c.v not in (1, 2):
                raise UnsupportedJpegError(
                    f"Unsupported luma sampling factors: {c.h}x{c.v}")
        else:
            if c.h != 1 or c.v != 1:
                raise UnsupportedJpegError(
                    f"Unsupported chroma sampling factors: {c.h}x{c.v}")
    if ncomp == 1:
        # Grayscale MCU is a single 8x8 block regardless of declared factors.
        comps[0].h = comps[0].v = 1

    header.components = comps
    if cur.pos - start != length:
        raise JpegError("SOF segment length mismatch")


def _read_sos(cur: _Cursor, header: JpegHeader) -> ScanData:
    """SOS scan header with baseline/progressive validity rules."""
    if not header.components:
        raise JpegError("SOS marker before SOF")
    length = cur.u16() - 2
    start = cur.pos

    nscan = cur.u8()
    if not header.progressive and nscan != header.ncomp:
        raise UnsupportedJpegError(
            f"Scan component count {nscan} != frame component count {header.ncomp} "
            "(non-interleaved baseline scans not supported)")
    if not 1 <= nscan <= header.ncomp:
        raise JpegError(f"Invalid scan component count: {nscan}")

    by_id = {c.component_id: i for i, c in enumerate(header.components)}
    comp_indices: list = []
    dc_ids: list = []
    ac_ids: list = []
    for _ in range(nscan):
        cid = cur.u8()
        if header.zero_based_ids:
            cid += 1
        ci = by_id.get(cid)
        if ci is None:
            raise JpegError(f"Invalid color component ID in scan: {cid}")
        tables = cur.u8()
        dc_id = tables >> 4
        ac_id = tables & 0x0F
        if dc_id > 3 or ac_id > 3:
            raise JpegError("Invalid Huffman table ID in scan header")
        comp_indices.append(ci)
        dc_ids.append(dc_id)
        ac_ids.append(ac_id)
    if comp_indices != sorted(set(comp_indices)):
        raise JpegError("Scan components must be unique and in frame order")

    ss = cur.u8()
    se = cur.u8()
    approx = cur.u8()
    scan = ScanSpec(ss, se, approx >> 4, approx & 0x0F)
    if header.scan is None:
        header.scan = scan
        # Legacy view: first scan's table selectors on the components.
        for ci, dc_id, ac_id in zip(comp_indices, dc_ids, ac_ids):
            header.components[ci].dc_id = dc_id
            header.components[ci].ac_id = ac_id

    if header.progressive:
        # Progressive spectral selection / successive approximation rules
        # (reference: src/jpeg_scanner.cpp:79-106).
        if scan.start_of_selection > scan.end_of_selection or scan.end_of_selection > 63:
            raise JpegError(
                f"Invalid spectral selection ({scan.start_of_selection}-"
                f"{scan.end_of_selection})")
        if scan.start_of_selection == 0 and scan.end_of_selection != 0:
            raise JpegError("DC and AC coefficients mixed in one progressive scan")
        if scan.start_of_selection != 0 and nscan != 1:
            raise JpegError("Progressive AC scan must have exactly one component")
        if scan.successive_high not in (0, scan.successive_low + 1):
            raise JpegError(
                f"Invalid successive approximation ({scan.successive_high},"
                f"{scan.successive_low})")
    else:
        if scan.start_of_selection != 0 or scan.end_of_selection != 63:
            raise JpegError(
                f"Invalid spectral selection for baseline scan "
                f"({scan.start_of_selection}-{scan.end_of_selection})")
        if scan.successive_high != 0 or scan.successive_low != 0:
            raise JpegError("Invalid successive approximation for baseline scan")

    if cur.pos - start != length:
        raise JpegError("SOS segment length mismatch")
    return ScanData(comp_indices, dc_ids, ac_ids, scan,
                    header.restart_interval)


def _read_dri(cur: _Cursor, header: JpegHeader) -> None:
    length = cur.u16()
    if length != 4:
        raise JpegError(f"Invalid DRI segment length: {length}")
    header.restart_interval = cur.u16()


def _skip_segment(cur: _Cursor) -> None:
    """APPN / COM / other length-prefixed segments we ignore."""
    length = cur.u16()
    if length < 2:
        raise JpegError(f"Invalid segment length: {length}")
    cur.take(length - 2)


def _scan_entropy(data: bytes, pos: int,
                  stop_at_marker: bool = False) -> Tuple[bytes, Tuple[int, ...], int]:
    """De-stuff the entropy-coded segment starting at `pos`.

    Native C++ fast path when available (binding.destuff_cpp; the
    reference's scan is C++ too, reference: src/jpeg_scanner.cpp:405-433);
    the pure-Python implementation below is the semantic reference and
    fallback — both are differentially tested byte-for-byte.
    """
    if os.environ.get("PIM_JPEG_TPU_NO_NATIVE") != "1":
        try:
            from pim_jpeg_decoder_tpu.native.binding import destuff_cpp
            res = destuff_cpp(data, pos, stop_at_marker)
            if res is not None:
                return res
        except ImportError:
            pass
    return _scan_entropy_py(data, pos, stop_at_marker)


def _scan_entropy_py(data: bytes, pos: int,
                     stop_at_marker: bool = False) -> Tuple[bytes, Tuple[int, ...], int]:
    """De-stuff the entropy-coded segment starting at `pos`.

    Returns (destuffed_bytes, restart_segment_offsets, end_pos) where
    end_pos is just past the EOI, or — with ``stop_at_marker`` (multi-scan
    progressive streams) — the position OF the terminating marker's 0xFF.

    Baseline semantics mirror the reference entropy scan
    (reference: src/jpeg_scanner.cpp:405-433): 0xFF 0x00 collapses to 0xFF,
    RST0-7 markers are removed (we additionally record the de-stuffed offset
    where the following segment begins), stray 0xFF fill bytes are
    tolerated, EOI terminates, and any other marker raises unless
    ``stop_at_marker``.

    Vectorized: bulk-copies the runs between 0xFF positions so the Python
    loop only touches actual 0xFF bytes.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    out_chunks: List[np.ndarray] = []
    offsets: List[int] = [0]
    out_len = 0

    def joined() -> bytes:
        out = np.concatenate(out_chunks) if out_chunks else np.zeros(0, np.uint8)
        return out.tobytes()

    ff_positions = np.flatnonzero(buf[pos:] == 0xFF) + pos
    prev = pos
    i = 0
    n_ff = len(ff_positions)
    while i < n_ff:
        p = int(ff_positions[i])
        if p < prev:          # consumed by a previous marker-pair skip
            i += 1
            continue
        if p > prev:
            out_chunks.append(buf[prev:p])
            out_len += p - prev
        if p + 1 >= len(buf):
            raise JpegError("Unexpected end of JPEG inside entropy-coded data")
        nxt = buf[p + 1]
        if nxt == 0x00:                      # byte-stuffed 0xFF data byte
            out_chunks.append(buf[p:p + 1])
            out_len += 1
            prev = p + 2
        elif 0xD0 <= nxt <= 0xD7:            # RSTn: segment boundary
            offsets.append(out_len)
            prev = p + 2
        elif nxt == 0xD9:                    # EOI (left unconsumed when the
            return joined(), tuple(offsets), (p if stop_at_marker else p + 2)
        elif nxt == 0xFF:                    # fill byte; re-examine next 0xFF
            prev = p + 1
        elif stop_at_marker:                 # next scan's marker segment
            return joined(), tuple(offsets), p
        else:
            raise JpegError(
                f"Invalid marker {M.marker_name(0xFF00 | int(nxt))} inside "
                "entropy-coded data (multi-scan streams not supported)")
        i += 1
    raise JpegError("Unexpected end of JPEG: no EOI marker")


def scan_jpeg(data: bytes) -> JpegHeader:
    """Parse a complete baseline JPEG byte stream into a :class:`JpegHeader`.

    Top-level scanner equivalent to the reference's ``read_JPEG``
    (reference: src/jpeg_scanner.cpp:345-436): SOI check, marker dispatch
    until SOS, then the entropy scan to EOI.
    """
    if len(data) < 4:
        raise JpegError("JPEG too short")
    cur = _Cursor(data)
    if cur.u16() != M.SOI:
        raise JpegError("JPEG does not start with SOI marker")

    header = JpegHeader()
    while True:
        marker = cur.u16()
        while marker == 0xFFFF:  # fill bytes before a marker
            marker = (marker << 8 | cur.u8()) & 0xFFFF

        if marker == M.SOS:
            scan = _read_sos(cur, header)
            # Snapshot the table definitions in effect for THIS scan.
            scan.dc_specs = [header.dc_tables.get(t) for t in scan.dc_ids]
            scan.ac_specs = [header.ac_tables.get(t) for t in scan.ac_ids]
            scan.entropy_bytes, scan.segment_offsets, end = _scan_entropy(
                data, cur.pos, stop_at_marker=header.progressive)
            header.scans.append(scan)
            cur.pos = end
            if not header.progressive:
                # Baseline: exactly one scan; _scan_entropy consumed to EOI
                # (erroring on stray markers like the reference).
                break
            # Progressive: keep reading markers — tables may be redefined
            # between scans; EOI ends the stream.
            nxt = cur.u16()
            if nxt == M.EOI:
                break
            cur.pos -= 2
        elif marker == M.EOI and header.scans:
            break
        elif marker in (M.SOF0, M.SOF2):
            _read_sof(cur, header, marker)
        elif marker == M.DQT:
            _read_dqt(cur, header)
        elif marker == M.DHT:
            _read_dht(cur, header)
        elif marker == M.DRI:
            _read_dri(cur, header)
        elif marker in M.APP_MARKERS or marker == M.COM:
            _skip_segment(cur)
        elif marker in M.JPG_SKIP_MARKERS or marker in (M.DNL, M.DHP, M.EXP):
            _skip_segment(cur)
        elif marker == M.TEM:
            pass  # standalone marker, no segment body
        elif marker in M.SOF_MARKERS:
            raise UnsupportedJpegError(
                f"Unsupported frame type {M.marker_name(marker)} "
                "(only baseline SOF0 and progressive SOF2 are recognized)")
        elif marker == M.DAC:
            raise UnsupportedJpegError("Arithmetic coding not supported")
        elif marker in M.RST_MARKERS:
            raise JpegError("RSTn marker before start of scan")
        elif marker == M.EOI:
            raise JpegError("EOI marker before start of scan")
        elif marker == M.SOI:
            raise JpegError("Embedded JPEGs not supported")
        elif (marker >> 8) != 0xFF:
            raise JpegError(f"Expected a marker, got 0x{marker:04X}")
        else:
            raise JpegError(f"Unknown marker: {M.marker_name(marker)}")

    # Structural validation.
    for c in header.components:
        if c.qt_id not in header.quant_tables:
            raise JpegError(
                f"Color component {c.component_id} references missing "
                f"quantization table {c.qt_id}")
    for scan in header.scans:
        first_pass = scan.spec.successive_high == 0
        for i in range(len(scan.component_indices)):
            if scan.spec.start_of_selection == 0 and first_pass:
                if scan.dc_specs[i] is None:
                    raise JpegError(
                        f"Scan references missing DC Huffman table "
                        f"{scan.dc_ids[i]}")
            if scan.spec.end_of_selection > 0:   # band includes AC coeffs
                if scan.ac_specs[i] is None:
                    raise JpegError(
                        f"Scan references missing AC Huffman table "
                        f"{scan.ac_ids[i]}")

    # Legacy single-scan view (the baseline fast path's interface).
    header.entropy_bytes = header.scans[0].entropy_bytes
    header.segment_offsets = header.scans[0].segment_offsets
    return header
