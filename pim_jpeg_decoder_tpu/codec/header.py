"""Parsed-JPEG data model.

Equivalent of the reference's ``Header`` family
(reference: src/headers/jpeg.h:124-179: ``QuantizationTable``,
``HuffmanTable``, ``ColorComponent``, ``Header``).  Differences by design:

- quant tables are stored de-zigzagged (natural order) as NumPy arrays, like
  the reference stores them after DQT load (reference: src/jpeg_scanner.cpp:306,311);
- the entropy stream is kept as de-stuffed bytes plus *restart segment
  offsets* so entropy decode can run segment-parallel — the reference strips
  RST markers without recording offsets (reference: src/jpeg_scanner.cpp:423);
- MCU-grid geometry is derived once here instead of being recomputed at each
  consumer (reference recomputes in scanner/bmp_writer/host).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


class JpegError(ValueError):
    """Invalid or unsupported JPEG bitstream.

    The reference reports these conditions by setting ``header->valid = false``
    with a printed reason (e.g. reference: src/jpeg_scanner.cpp:8-10,197-201);
    we raise instead, with equivalent messages.
    """


class UnsupportedJpegError(JpegError):
    """Well-formed JPEG using a feature this decoder does not support."""


@dataclasses.dataclass
class QuantTable:
    """One quantization table, values in natural (row-major) order."""
    table_id: int
    precision: int            # 0 => 8-bit entries, 1 => 16-bit entries
    values: np.ndarray        # [64] uint16, natural order


@dataclasses.dataclass
class HuffmanTableSpec:
    """One DHT table: canonical counts-per-length + symbols."""
    table_id: int
    table_class: int          # 0 = DC, 1 = AC
    counts: np.ndarray        # [16] uint8 — number of codes of length 1..16
    symbols: np.ndarray       # [sum(counts)] uint8


@dataclasses.dataclass
class Component:
    """One frame component (Y, Cb or Cr)."""
    component_id: int         # as stored in the file (after zero-base fixup)
    h: int                    # horizontal sampling factor
    v: int                    # vertical sampling factor
    qt_id: int                # quantization table selector
    dc_id: int = 0            # DC Huffman table selector (from SOS)
    ac_id: int = 0            # AC Huffman table selector (from SOS)


@dataclasses.dataclass
class ScanSpec:
    """SOS parameters (needed for progressive validation)."""
    start_of_selection: int
    end_of_selection: int
    successive_high: int
    successive_low: int


@dataclasses.dataclass
class ScanData:
    """One complete scan: SOS parameters + its entropy-coded payload.

    Baseline images have exactly one; progressive images carry a sequence
    (DC first/refine, per-component AC first/refine bands).  The reference
    carries progressive block-decode paths but its single-scan reader can
    never reach a second scan (reference: src/jpeg_scanner.cpp:425-430);
    multi-scan support here is a deliberate capability extension.
    """
    component_indices: List[int]      # indices into header.components
    dc_ids: List[int]                 # per scan-component DC table selector
    ac_ids: List[int]                 # per scan-component AC table selector
    spec: "ScanSpec"
    restart_interval: int             # DRI value in effect for this scan
    entropy_bytes: bytes = b""
    segment_offsets: Tuple[int, ...] = (0,)
    # Huffman table SNAPSHOTS captured at SOS time — DHT may redefine a
    # table id between scans, so selectors alone are not stable.
    dc_specs: List[Optional["HuffmanTableSpec"]] = dataclasses.field(
        default_factory=list)
    ac_specs: List[Optional["HuffmanTableSpec"]] = dataclasses.field(
        default_factory=list)

    @property
    def interleaved(self) -> bool:
        return len(self.component_indices) > 1


@dataclasses.dataclass
class JpegHeader:
    """Everything parsed out of a JPEG up to (and including) the scan header."""
    width: int = 0
    height: int = 0
    precision: int = 8
    progressive: bool = False
    components: List[Component] = dataclasses.field(default_factory=list)
    quant_tables: dict = dataclasses.field(default_factory=dict)    # id -> QuantTable
    dc_tables: dict = dataclasses.field(default_factory=dict)       # id -> HuffmanTableSpec
    ac_tables: dict = dataclasses.field(default_factory=dict)       # id -> HuffmanTableSpec
    restart_interval: int = 0
    scan: Optional[ScanSpec] = None
    zero_based_ids: bool = False

    # All scans in stream order (baseline: exactly one).
    scans: List[ScanData] = dataclasses.field(default_factory=list)

    # Entropy-coded payload of the FIRST scan: de-stuffed bytes (0xFF00
    # collapsed, RSTn removed) and offsets (into `entropy_bytes`) where each
    # restart segment begins.  segment_offsets[0] == 0 always;
    # len(segment_offsets) == number of restart segments in the scan.
    # (Kept as top-level fields for the baseline fast path; progressive
    # consumers iterate `scans`.)
    entropy_bytes: bytes = b""
    segment_offsets: Tuple[int, ...] = (0,)

    # --- geometry -----------------------------------------------------------

    @property
    def ncomp(self) -> int:
        return len(self.components)

    @property
    def h_max(self) -> int:
        return max(c.h for c in self.components)

    @property
    def v_max(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcu_cols(self) -> int:
        """MCUs per row (an MCU covers 8*h_max x 8*v_max pixels)."""
        return -(-self.width // (8 * self.h_max))

    @property
    def mcu_rows(self) -> int:
        return -(-self.height // (8 * self.v_max))

    @property
    def num_mcus(self) -> int:
        return self.mcu_cols * self.mcu_rows

    @property
    def blocks_per_mcu(self) -> int:
        """Number of 8x8 blocks per MCU ('g' in the device layout)."""
        return sum(c.h * c.v for c in self.components)

    @property
    def mode_key(self) -> Tuple[int, int, int]:
        """(h_max, v_max, ncomp) — selects the fused-kernel variant."""
        return (self.h_max, self.v_max, self.ncomp)

    def comp_blocks(self, ci: int) -> Tuple[int, int]:
        """Unpadded (blocks_wide, blocks_high) of component ci — the block
        grid a non-interleaved (progressive) scan covers (T.81 A.2.2)."""
        c = self.components[ci]
        w = -(-self.width * c.h // self.h_max)
        h = -(-self.height * c.v // self.v_max)
        return (-(-w // 8), -(-h // 8))

    def comp_blocks_padded(self, ci: int) -> Tuple[int, int]:
        """MCU-padded (blocks_wide, blocks_high) of component ci — the block
        grid interleaved scans cover."""
        c = self.components[ci]
        return (self.mcu_cols * c.h, self.mcu_rows * c.v)

    def component_qt(self, comp: Component) -> np.ndarray:
        qt = self.quant_tables.get(comp.qt_id)
        if qt is None:
            raise JpegError(
                f"Color component references missing quantization table {comp.qt_id}")
        return qt.values

    def slot_components(self) -> List[Tuple[int, int, int]]:
        """MCU slot layout: list of (component_index, qv, qh) per 8x8 block slot.

        Slot order matches the interleaved scan order of ITU-T T.81 A.2.3:
        components in frame order; within a component, its v x h blocks in
        raster order.  For 4:2:0 this yields [Y00, Y01, Y10, Y11, Cb, Cr].
        """
        slots = []
        for ci, c in enumerate(self.components):
            for qv in range(c.v):
                for qh in range(c.h):
                    slots.append((ci, qv, qh))
        return slots
