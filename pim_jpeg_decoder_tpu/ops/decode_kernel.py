"""Device decode: dequantize -> IDCT -> upsample -> YCbCr->RGB in plain JAX.

This one jitted program replaces the reference's entire DPU program — its
three separate phases each round-tripped every block through MRAM
(dequantize / idct / convert_colorspace, reference: src/decoder_dpu.c:94-107,
~3x the necessary memory traffic per SURVEY.md section 3.4).  Here the whole
integer chain is elementwise over the MCU axis, so XLA fuses it: coefficients
are read once and pixels written once.

Layout ("MCUs last"):
  - coefficients arrive as ``[M, g, 64]`` int16 (or int8 on the compact
    wire) and are dequantized into ``[g, 8, 8, M]`` int32, so every
    butterfly operand is contiguous over the MCU axis and every output
    layout keeps the MCU axis last.  Slots of one kind (all luma, both
    chroma) go through one batched IDCT, which keeps the program small
    and its compile short.
  - one program is compiled per sampling mode (static slot geometry — no
    dynamic dispatch, unlike the reference's per-block (v,h) switch at
    reference: src/decoder_dpu.c:332-355).
  - per-image quantization tables are an integer gather ``qpool[qidx]``
    (exact for every 16-bit DQT entry); this replaces the reference's
    per-DPU metadata quant staging (reference: src/decoder_dpu.c:112-132).

Bit-exactness: arithmetic is the shared spec (ops/specs.py, ops/idct_math.py);
tests assert equality with the NumPy oracle for every mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.idct_math import idct_1d
from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache

# MCU padding granule: every device batch holds a multiple of this many
# MCUs, so the engine, the batch packer and the mesh alignment agree on
# launch shapes.
LANE_TILE = 512

# Maximum images whose quant tables can share one device batch.
MAX_IMAGES_PER_BATCH = 16


def _idct_pass1(x32):
    """Pass 1 over vertical freqs: ``[..., v, u, M]`` -> list over spatial
    row r of ``[..., u, M]``.  Leading axes batch slots of one kind."""
    return idct_1d([x32[..., v, :, :] for v in range(8)],
                   S.CONST_BITS - S.PASS1_BITS)


def _idct_pass2(rows1):
    """rows1: list over r of [..., u, M] -> list over spatial col p of
    [..., r, M]."""
    y = jnp.stack(rows1, axis=-2)                 # [..., freq u, row r, M]
    return idct_1d([y[..., u, :, :] for u in range(8)],
                   S.CONST_BITS + S.PASS1_BITS + 3)


def _assemble_pm(cols2):
    """list over p of [..., r, M] -> [..., p, r, M] (COLUMN-major pixel
    order), clamped to the sample range.

    The native pixel order within a slot is px*n + py; the host assembly
    and the C++ converter absorb the order for free."""
    return jnp.clip(jnp.stack(cols2, axis=-3), S.SAMPLE_MIN, S.SAMPLE_MAX)


def _reduced_pass(xs, mat, shift):
    """One n-point reduced-IDCT pass: xs is a freq-indexed list of n
    arrays; returns the n transformed arrays (spec: specs.py 'Reduced
    (scaled) IDCT')."""
    n = len(mat)
    outs = []
    for k in range(n):
        acc = xs[0] * mat[k][0]
        for u in range(1, n):
            acc = acc + xs[u] * mat[k][u]
        outs.append(S.descale(acc, shift))
    return outs


def _reduced_idct_lists(x32, ny: int, nx: int):
    """Reduced (ny x nx)-point IDCT of the top-left frequency sub-block.

    ``x32`` is ``[..., 8, 8, M]``.  Returns the pass-2 output as a list over
    spatial col p (nx entries) of ``[..., ny, M]`` arrays — same list
    structure as the full-scale path, so slot selection stays free Python
    indexing.  Scaled decode uses the reduced-matrix convention for BOTH
    passes (including ny/nx == 8): the matrices carry the 1/2-per-pass
    normalization, shifts are CONST_BITS - PASS1_BITS then
    CONST_BITS + PASS1_BITS (specs.py 'Reduced (scaled) IDCT').
    """
    mat1 = S.reduced_idct_matrix(ny)
    xs = [x32[..., v, 0:nx, :] for v in range(ny)]   # top-left ny x nx freqs
    rows1 = _reduced_pass(xs, mat1, S.CONST_BITS - S.PASS1_BITS)
    mat2 = S.reduced_idct_matrix(nx)
    y = jnp.stack(rows1, axis=-2)                     # [..., freq u, row, M]
    return _reduced_pass([y[..., u, :, :] for u in range(nx)], mat2,
                         S.CONST_BITS + S.PASS1_BITS)


def _color(y, cb, cr):
    """Fixed-point BT.601 (spec constants); returns (r, g, b) int32."""
    y128 = y + 128
    r = y128 + S.descale(S.FIX_CR_R * cr, S.COLOR_BITS)
    g = y128 + S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr, S.COLOR_BITS)
    b = y128 + S.descale(S.FIX_CB_B * cb, S.COLOR_BITS)
    return r, g, b


def _to_u8(plane):
    return jnp.clip(plane, 0, 255).astype(jnp.uint8)


def _dequantize(coeffs, qidx, qpool):
    """``[M, g, 64]`` coefficients -> ``[g, 8, 8, M]`` int32, dequantized
    with each MCU's own image tables and clamped into int16 range."""
    q = qpool.astype(jnp.int32)[qidx]                       # [M, g, 64]
    deq = jnp.clip(coeffs.astype(jnp.int32) * q,
                   -S.DEQUANT_CLAMP - 1, S.DEQUANT_CLAMP)
    return jnp.transpose(deq, (1, 2, 0)).reshape(coeffs.shape[1], 8, 8, -1)


def _rgb_planes(x, mode: S.ModeSpec, scale: int):
    """Dequantized ``[g, 8, 8, M]`` -> ``[3, luma_slots, nn, M]`` uint8 RGB.

    All luma slots go through one batched IDCT, and both chroma planes
    through another.  ``scale`` in {1, 2, 4, 8} selects full or reduced
    (n = 8/scale point) IDCT output — the scaled-decode capability
    (specs.py 'Reduced IDCT').
    """
    m = x.shape[-1]
    gy, n = mode.luma_slots, 8 // scale
    luma = x[:gy]
    if scale == 1:
        spat = _assemble_pm(_idct_pass2(_idct_pass1(luma)))  # [gy, p, r, M]
    else:
        spat = _assemble_pm(_reduced_idct_lists(luma, n, n))

    if mode.ncomp == 1:
        gray = _to_u8(spat + 128).reshape(1, n * n, m)
        return jnp.stack([gray] * 3)

    chroma = x[gy:gy + 2]                                    # [2, 8, 8, M]
    if scale == 1:
        # Chroma with FUSED nearest-neighbor upsample: replication
        # commutes with the per-row/per-col IDCT passes, so upsampling
        # is free Python list selection — rows are duplicated between
        # pass 1 and pass 2 (one extra chroma pass 2 per distinct qv
        # when v == 2), columns on the pass-2 output list (the reference
        # does it per pixel, reference: src/decoder_dpu.c:338-355,370).
        #
        # The BT.601 chroma terms are likewise computed ONCE at chroma
        # resolution and replicated per slot afterwards — 1/4 the color
        # multiplies for 4:2:0 (replication commutes with the elementwise
        # term arithmetic too).
        rh, rw = 8 // mode.v, 8 // mode.h
        rows1 = _idct_pass1(chroma)
        terms = {}
        for qv in range(mode.v):
            sel = (rows1 if mode.v == 1 else
                   [rows1[qv * rh + r // mode.v] for r in range(8)])
            cb, cr = _assemble_pm(_idct_pass2(sel))      # [p, r, M] each
            terms[qv] = (
                S.descale(S.FIX_CR_R * cr, S.COLOR_BITS),
                S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr, S.COLOR_BITS),
                S.descale(S.FIX_CB_B * cb, S.COLOR_BITS))

        def slot_terms(ch):
            out = []
            for s in range(gy):
                qv, qh = mode.luma_slot_pos(s)
                t = terms[qv][ch]
                if mode.h != 1:                          # column replication
                    t = jnp.repeat(t[qh * rw:(qh + 1) * rw], mode.h, axis=0)
                out.append(t)
            return jnp.stack(out)                        # [gy, p, r, M]

        y128 = spat + 128
        planes = [y128 + slot_terms(ch) for ch in range(3)]
    else:
        # Scaled decode: chroma covers v x h MCU cells per block, so at
        # scale >= 2 its reduced output is (v*n) x (h*n) — no upsample
        # at all (chroma is reduced LESS than luma, matching libjpeg's
        # scaled 4:2:0 behavior where 1/2-scale chroma is full 8x8).
        # Slot (qv, qh) takes its n x n region by slicing.
        cc = _assemble_pm(_reduced_idct_lists(chroma, mode.v * n,
                                              mode.h * n))  # [2, p, r, M]

        def chroma_slots(ci):
            out = []
            for s in range(gy):
                qv, qh = mode.luma_slot_pos(s)
                out.append(cc[ci, qh * n:(qh + 1) * n, qv * n:(qv + 1) * n])
            return jnp.stack(out)                        # [gy, p, r, M]

        planes = _color(spat, chroma_slots(0), chroma_slots(1))
    return jnp.stack([_to_u8(p).reshape(gy, n * n, m) for p in planes])


def _ycbcr_planes(x):
    """Wire-optimal variant: dequant + IDCT only, emitting level-shifted
    uint8 YCbCr planes ``[g, 64, M]`` in the SUBSAMPLED layout (one 64-byte
    plane per slot per MCU).  For 4:2:0 that is 1.5 B/px on the wire vs
    3 B/px RGB — the host finishes upsample + BT.601 with the identical
    integer spec, so the final RGB is bit-identical to the RGB path
    (tested)."""
    g, m = x.shape[0], x.shape[-1]
    spat = _assemble_pm(_idct_pass2(_idct_pass1(x)))        # [g, p, r, M]
    return (spat + 128).astype(jnp.uint8).reshape(g, 64, m)


def decode_mcus_impl(
    coeffs: jax.Array,        # [M, g, 64] int16 (or int8 wire) coefficients
    qidx: jax.Array,          # [M] int32 image index per MCU
    qpool: jax.Array,         # [Q, g, 64] per-slot quant rows
    *,
    mode: S.ModeSpec,
    raw: bool = False,
    ycbcr: bool = False,
    scale: int = 1,
) -> jax.Array:
    """Traceable (un-jitted) device decode — usable inside shard_map/jit.

    With ``raw=True`` returns the channel-planar layout
    ``[3, luma_slots, nn, M]`` and skips the raster-layout transpose (a real
    device-memory copy), so the raw path touches device memory exactly twice
    (coefficients in, RGB out).  Host raster assembly absorbs the layout at
    no extra cost, so the engine uses raw=True.

    Pixel order within a slot is COLUMN-major (index = px*n + py) in every
    output layout — see _assemble_pm.
    """
    assert scale in (1, 2, 4, 8), scale
    assert not (ycbcr and scale != 1), "ycbcr transport is full-scale only"
    x = _dequantize(coeffs, qidx, qpool)
    if ycbcr:
        return _ycbcr_planes(x)
    rgb = _rgb_planes(x, mode, scale)
    if raw:
        return rgb
    # [3, gy, nn, M] -> [M, gy, nn, 3] (slot-major per MCU).  This is a real
    # device-memory copy (the default output layout differs); prefer raw.
    return jnp.transpose(rgb, (3, 1, 2, 0))


_decode_mcus_jit = jax.jit(
    decode_mcus_impl, static_argnames=("mode", "raw", "ycbcr", "scale"))


def decode_mcus(coeffs, qidx, qpool, mode: S.ModeSpec,
                lane_tile: int = LANE_TILE, raw: bool = False,
                ycbcr: bool = False, scale: int = 1) -> jax.Array:
    """Decode a batch of MCUs on device.

    Args:
      coeffs: ``[M, g, 64]`` int16 raw (entropy-decoded) coefficients,
        natural order; M must be a multiple of ``lane_tile`` (pad with
        zeros — padded MCUs decode to gray and are never assembled).
      qidx: ``[M]`` int32 image index per MCU (selects quant tables).
      qpool: ``[Q, g, 64]`` per-slot quantizer rows (integer-valued).
      mode: sampling mode (one compiled program per mode).
      lane_tile: the MCU padding granule ``M`` is checked against.
      raw: return the channel-planar ``[3, luma_slots, nn, M]`` layout and
        skip the raster transpose (a real device-memory copy).
      ycbcr: return level-shifted uint8 YCbCr planes ``[g, 64, M]`` in the
        subsampled layout (1.5 B/px for 4:2:0) for host-side upsample +
        color — the wire-optimal transport when the result leaves the card.
      scale: 1 (full) or 2/4/8 for reduced-IDCT scaled decode — each slot
        emits (8/scale)^2 pixels (libjpeg scaled-decode equivalent; see
        specs.py 'Reduced IDCT').

    Returns:
      ``[M, luma_slots, nn, 3]`` uint8 RGB where nn = (8/scale)^2,
      ``[3, luma_slots, nn, M]`` with ``raw=True``, or ``[g, 64, M]`` with
      ``ycbcr=True`` (full scale only).
    """
    if coeffs.shape[0] % lane_tile:
        raise ValueError(f"M={coeffs.shape[0]} must be a multiple of "
                         f"lane_tile={lane_tile}")
    ensure_compilation_cache()
    return _decode_mcus_jit(coeffs, qidx, qpool, mode=mode, raw=raw,
                            ycbcr=ycbcr, scale=scale)


def pad_mcus(num_mcus: int, lane_tile: int = LANE_TILE) -> int:
    """Round an MCU count up to the lane-tile padding granule."""
    return -(-num_mcus // lane_tile) * lane_tile
