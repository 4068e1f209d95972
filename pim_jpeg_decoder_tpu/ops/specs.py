"""The fixed-point decode spec shared by the NumPy oracle and the device.

Bit-exactness contract: every implementation (NumPy oracle, device program,
C++ host path) computes dequantize -> IDCT -> level shift -> upsample ->
color conversion with EXACTLY the integer arithmetic defined here, so their
outputs are bit-identical (SURVEY.md section 4 "bit-exactness decision point").

The reference implements the same three stages as fixed-point integer code on
the DPU (reference: src/decoder_dpu.c:158-390) with AAN-style IDCT constants
and BT.601 constants at scale 2^22.  We use the classic 13-bit Loeffler
integer IDCT (the ISO/IEC compliance-grade scheme) and BT.601 at scale 2^16
instead: same capability, independently specified arithmetic, well within the
IEEE 1180 tolerance of the ideal float IDCT (validated in tests).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# --- Integer IDCT (Loeffler-Ligtenberg-Moshovitz, 13-bit constants) ----------
# Constants are round(x * 2^CONST_BITS).

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172

# Dequantized coefficients are clamped into int16 range before the IDCT so
# every intermediate fits in int32 even for pathological 16-bit quant tables.
DEQUANT_CLAMP = 32767

# IDCT output samples are clamped to the 8-bit sample range (centered at 0)
# per ITU-T T.81 A.3.1 — libjpeg does the same via its range-limit table, so
# this keeps 4:4:4/grayscale decode pixel-exact vs libjpeg even when noise
# blocks push the IDCT out of range.
SAMPLE_MIN = -128
SAMPLE_MAX = 127

# --- Reduced (scaled) IDCT ----------------------------------------------------
# Scaled decode (1/2, 1/4, 1/8 like libjpeg's jpeg_idct_4x4/2x2/1x1): an
# n-point inverse transform of the top-left n x n frequency sub-block,
#   s[k] = (1/2) * sum_{u<n} C_u F_u cos((2k+1) u pi / (2n)),  C_0 = 1/sqrt(2)
# whose flat-block response per pass is 1/(2*sqrt(2)) — two passes give the
# standard 1/8, so a DC-only block decodes to the same intensity at every
# scale.  Constants are round(basis * 2^CONST_BITS); both passes multiply by
# the integer matrix and descale (pass 1 by CONST_BITS - PASS1_BITS, pass 2
# by CONST_BITS + PASS1_BITS), then clamp to the sample range.  Subsampled
# chroma reduces per-axis to (sampling_factor * n) points — less than luma,
# no upsampling at scale >= 2 (matches libjpeg, where 1/2-scale 4:2:0
# chroma is the full 8x8).  The oracle and the device program share these
# matrices, so bit-exactness between them is by construction (full-scale
# decode is unaffected: scale=1 uses the Loeffler butterfly above).

SCALED_SIZES = (4, 2, 1)   # 1/2, 1/4, 1/8 of full resolution


def reduced_idct_matrix(n: int):
    """[n, n] integer basis matrix for the n-point reduced IDCT."""
    import math
    rows = []
    for k in range(n):
        row = []
        for u in range(n):
            cu = (1.0 / math.sqrt(2.0)) if u == 0 else 1.0
            basis = 0.5 * cu * math.cos((2 * k + 1) * u * math.pi / (2 * n))
            row.append(round(basis * (1 << CONST_BITS)))
        rows.append(row)
    return rows


# --- Fixed-point BT.601 color conversion (scale 2^16) ------------------------
# R = Y + 1.402 Cr; G = Y - 0.344136 Cb - 0.714136 Cr; B = Y + 1.772 Cb
# with chroma centered at 0 (IDCT output before level shift) and +128 level
# shift applied to Y.  DESCALE rounding: (x + 2^15) >> 16, arithmetic shift.

COLOR_BITS = 16
FIX_CR_R = 91881       # round(1.402 * 2^16)
FIX_CB_G = -22554      # round(-0.344136 * 2^16)
FIX_CR_G = -46802      # round(-0.714136 * 2^16)
FIX_CB_B = 116130      # round(1.772 * 2^16)


def descale(x, n: int):
    """Rounding arithmetic right shift: (x + 2^(n-1)) >> n.

    Works for Python ints, NumPy arrays and JAX arrays (both use arithmetic
    shift for signed ints, matching the reference's behavior on negative
    values — SURVEY.md section 7 "hard parts").
    """
    return (x + (1 << (n - 1))) >> n


# --- Sampling-mode registry --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """Static geometry of one chroma-sampling mode.

    ``g`` 8x8 block slots per MCU in interleaved scan order; the first
    ``h * v`` slots are luma (raster order within the MCU), then Cb, Cr.
    One fused-kernel variant is compiled per mode (the reference dispatches
    per (v,h) inside the DPU kernel, reference: src/decoder_dpu.c:332-355).
    """
    name: str
    h: int                 # luma horizontal sampling factor
    v: int                 # luma vertical sampling factor
    ncomp: int
    g: int                 # blocks per MCU

    @property
    def luma_slots(self) -> int:
        return self.h * self.v

    @property
    def ycbcr_saves_bytes(self) -> bool:
        """True when YCbCr wire transport (g planes) carries fewer bytes
        than RGB (3 per luma slot) — every mode except 4:4:4."""
        return self.g < 3 * self.luma_slots

    @property
    def mcu_px_w(self) -> int:
        return 8 * self.h

    @property
    def mcu_px_h(self) -> int:
        return 8 * self.v

    def slot_component(self, s: int) -> int:
        """Component index of slot s (0=Y, 1=Cb, 2=Cr)."""
        if s < self.luma_slots:
            return 0
        return 1 + (s - self.luma_slots)

    def luma_slot_pos(self, s: int) -> Tuple[int, int]:
        """(qv, qh) position of luma slot s within the MCU."""
        return divmod(s, self.h)


MODES: Dict[Tuple[int, int, int], ModeSpec] = {
    (1, 1, 3): ModeSpec("4:4:4", 1, 1, 3, 3),
    (2, 1, 3): ModeSpec("4:2:2", 2, 1, 3, 4),
    (1, 2, 3): ModeSpec("4:4:0", 1, 2, 3, 4),
    (2, 2, 3): ModeSpec("4:2:0", 2, 2, 3, 6),
    (1, 1, 1): ModeSpec("gray", 1, 1, 1, 1),
}


def mode_for(mode_key: Tuple[int, int, int]) -> ModeSpec:
    mode = MODES.get(mode_key)
    if mode is None:
        h, v, ncomp = mode_key
        raise ValueError(f"Unsupported sampling mode: luma {h}x{v}, {ncomp} components")
    return mode


# MCU-count buckets: device buffers are padded up to one of these sizes so
# jit compiles a small, fixed set of programs (the reference instead fixes
# MAX_MCU_PER_DPU at compile time and zero-pads DPU work,
# reference: src/decoder_dpu.c:130).
MCU_BUCKETS: List[int] = [256, 1024, 4096, 16384, 65536]


def bucket_mcus(num_mcus: int) -> int:
    for b in MCU_BUCKETS:
        if num_mcus <= b:
            return b
    # Very large images are processed in chunks of the largest bucket.
    return MCU_BUCKETS[-1]
