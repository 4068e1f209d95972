"""Dtype-generic 8-point integer IDCT butterfly (spec implementation).

Pure arithmetic on whatever array type is passed in (NumPy int32 arrays for
the oracle, JAX int32 arrays in the device program), so the oracle and
the device execute literally the same butterfly — bit-exactness between
them is by construction, and correctness of the shared code is pinned
against the ideal float IDCT in tests/test_idct.py.

Algorithm: 13-bit Loeffler-Ligtenberg-Moshovitz integer IDCT (see
ops/specs.py for constants and the relationship to the reference's AAN
variant at reference: src/decoder_dpu.c:210-321).
"""

from __future__ import annotations

from pim_jpeg_decoder_tpu.ops import specs as S


def idct_1d(x, shift: int):
    """One 8-point Loeffler pass over a sequence of 8 int32 arrays.

    Returns the 8 transformed arrays, descaled by ``shift`` with rounding.
    All operations are elementwise +, -, *, <<, >> — valid for NumPy and JAX
    arrays alike; int32 overflow wraps identically on both.
    """
    in0, in1, in2, in3, in4, in5, in6, in7 = x

    # Even part.  The descale rounding bias (2^(shift-1)) is folded into
    # tmp0/tmp1 once instead of being added in each of the 8 descales:
    # every output derives from exactly one of tmp10..tmp13, each of which
    # carries the bias through tmp0/tmp1, so (x + bias + y) >> shift is
    # bit-identical to descale(x + y, shift).
    half = 1 << (shift - 1)
    z2 = in2
    z3 = in6
    z1 = (z2 + z3) * S.FIX_0_541196100
    tmp2 = z1 - z3 * S.FIX_1_847759065
    tmp3 = z1 + z2 * S.FIX_0_765366865
    tmp0 = ((in0 + in4) << S.CONST_BITS) + half
    tmp1 = ((in0 - in4) << S.CONST_BITS) + half
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    # Odd part.
    t0, t1, t2, t3 = in7, in5, in3, in1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * S.FIX_1_175875602
    t0 = t0 * S.FIX_0_298631336
    t1 = t1 * S.FIX_2_053119869
    t2 = t2 * S.FIX_3_072711026
    t3 = t3 * S.FIX_1_501321110
    z1 = z1 * (-S.FIX_0_899976223)
    z2 = z2 * (-S.FIX_2_562915447)
    z3 = z3 * (-S.FIX_1_961570560)
    z4 = z4 * (-S.FIX_0_390180644)
    z3 = z3 + z5
    z4 = z4 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    return (
        (tmp10 + t3) >> shift,
        (tmp11 + t2) >> shift,
        (tmp12 + t1) >> shift,
        (tmp13 + t0) >> shift,
        (tmp13 - t0) >> shift,
        (tmp12 - t1) >> shift,
        (tmp11 - t2) >> shift,
        (tmp10 - t3) >> shift,
    )
