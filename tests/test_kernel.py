"""Device decode tests: bit-exact agreement with the NumPy oracle.

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu); the same plain
JAX program compiles for the GPU, where the arithmetic is the identical
int32 chain (checked on the card by chip_smoke.py).
"""

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.codec.entropy import decode_scan
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.models.pipeline import (
    TpuJpegDecoder,
    assemble_raster_slots,
    build_qpool,
)
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus, pad_mcus
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle, mcu_rgb_from_coeffs

from tests.helpers import stage_single

LANE_TILE = 128  # small padding granule for fast tests


def slots_to_mcu_raster(mode: S.ModeSpec, slot_rgb: np.ndarray) -> np.ndarray:
    """[M, luma_slots, 64, 3] slot-major -> [M, v*8, h*8, 3] per-MCU raster."""
    m = slot_rgb.shape[0]
    out = np.empty((m, mode.mcu_px_h, mode.mcu_px_w, 3), np.uint8)
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        # Kernel slot pixels are COLUMN-major (px*8 + py).
        out[:, qv * 8:(qv + 1) * 8, qh * 8:(qh + 1) * 8, :] = (
            slot_rgb[:, s].reshape(m, 8, 8, 3).transpose(0, 2, 1, 3))
    return out


def run_kernel_vs_oracle(img, sampling=None, grayscale=False, quality=90):
    data = encode_jpeg(img, quality=quality,
                       sampling=sampling or "4:4:4", grayscale=grayscale)
    header = scan_jpeg(data)
    coeffs = decode_scan(header)
    padded, qidx, qpool, mode = stage_single(header, coeffs, LANE_TILE)
    got = np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                 lane_tile=LANE_TILE))

    want = mcu_rgb_from_coeffs(header, coeffs)
    got_raster = slots_to_mcu_raster(mode, got[: header.num_mcus])
    np.testing.assert_array_equal(got_raster, want)
    return header, got


class TestKernelBitExact:
    @pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:4:0", "4:2:0"])
    def test_modes_match_oracle(self, photo_image, sampling):
        run_kernel_vs_oracle(photo_image, sampling=sampling)

    def test_gray_matches_oracle(self, photo_image):
        run_kernel_vs_oracle(photo_image, grayscale=True)

    def test_noise_matches_oracle(self, noise_image):
        """Noise drives the IDCT into the sample clamp on both paths."""
        run_kernel_vs_oracle(noise_image, sampling="4:2:0", quality=95)

    def test_multi_image_quant_pool(self, photo_image, noise_image):
        """Two images with different quant tables in one device batch."""
        mode = S.mode_for((2, 2, 3))
        headers, coeffs_list = [], []
        for img, q in [(photo_image, 90), (noise_image, 40)]:
            data = encode_jpeg(img, quality=q, sampling="4:2:0")
            h = scan_jpeg(data)
            headers.append(h)
            coeffs_list.append(decode_scan(h))

        counts = [h.num_mcus for h in headers]
        m_pad = pad_mcus(sum(counts), LANE_TILE)
        coeffs = np.zeros((m_pad, mode.g, 64), np.int16)
        qidx = np.zeros(m_pad, np.int32)
        coeffs[: counts[0]] = coeffs_list[0]
        coeffs[counts[0]: counts[0] + counts[1]] = coeffs_list[1]
        qidx[counts[0]: counts[0] + counts[1]] = 1

        got = np.asarray(decode_mcus(coeffs, qidx, build_qpool(headers, mode),
                                     mode, lane_tile=LANE_TILE))
        off = 0
        for h, c in zip(headers, coeffs_list):
            want = mcu_rgb_from_coeffs(h, c)
            got_raster = slots_to_mcu_raster(mode, got[off: off + h.num_mcus])
            np.testing.assert_array_equal(got_raster, want)
            off += h.num_mcus


class TestPipelineEndToEnd:
    @pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
    def test_decode_matches_oracle(self, photo_image, sampling):
        data = encode_jpeg(photo_image, quality=85, sampling=sampling)
        got = TpuJpegDecoder(lane_tile=LANE_TILE).decode(data)
        want = decode_bytes_oracle(data)
        np.testing.assert_array_equal(got.rgb, want.rgb)

    def test_odd_dimensions_crop(self, rng):
        img = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
        data = encode_jpeg(img, quality=90, sampling="4:2:0")
        got = TpuJpegDecoder(lane_tile=LANE_TILE).decode(data)
        assert got.rgb.shape == (37, 61, 3)
        np.testing.assert_array_equal(got.rgb, decode_bytes_oracle(data).rgb)

    def test_dri_image(self, photo_image):
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0",
                           restart_interval=4)
        got = TpuJpegDecoder(lane_tile=LANE_TILE).decode(data)
        np.testing.assert_array_equal(got.rgb, decode_bytes_oracle(data).rgb)

    def test_assemble_raster_slots_layout(self):
        """Slot-major assembly agrees with a hand-built mapping."""
        from pim_jpeg_decoder_tpu.codec.header import Component, JpegHeader
        header = JpegHeader(width=32, height=32)
        header.components = [Component(1, 2, 2, 0), Component(2, 1, 1, 0),
                             Component(3, 1, 1, 0)]
        mode = S.mode_for(header.mode_key)
        # 2x2 MCUs; give every slot-pixel a unique value via arange.
        m = header.num_mcus
        slot_rgb = (np.arange(m * mode.luma_slots * 64 * 3) % 251).astype(
            np.uint8).reshape(m, mode.luma_slots, 64, 3)
        img = assemble_raster_slots(header, slot_rgb)
        assert img.shape == (32, 32, 3)
        # Pixel (y, x): MCU (y//16, x//16), luma slot ((y%16)//8, (x%16)//8),
        # slot pixels COLUMN-major (px*8 + py).
        for y, x in [(0, 0), (7, 9), (12, 3), (15, 15), (17, 2), (31, 31)]:
            mcu = (y // 16) * 2 + (x // 16)
            slot = ((y % 16) // 8) * 2 + ((x % 16) // 8)
            pix = (x % 8) * 8 + (y % 8)
            np.testing.assert_array_equal(img[y, x], slot_rgb[mcu, slot, pix])


class TestRawLayout:
    def test_raw_equals_default(self, photo_image):
        """raw=True returns the same pixels in kernel-native layout."""
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        padded, qidx, qpool, mode = stage_single(header, coeffs, LANE_TILE)
        default = np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                         lane_tile=LANE_TILE))
        raw = np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                     lane_tile=LANE_TILE, raw=True))
        assert raw.shape == (3, mode.luma_slots, 64, padded.shape[0])
        np.testing.assert_array_equal(raw.transpose(3, 1, 2, 0), default)

    def test_assemble_raster_raw_matches_slots(self, photo_image):
        from pim_jpeg_decoder_tpu.models.pipeline import (
            assemble_raster_raw,
            assemble_raster_slots,
        )
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        padded, qidx, qpool, mode = stage_single(header, coeffs, LANE_TILE)
        slots = np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                       lane_tile=LANE_TILE))
        raw = np.asarray(decode_mcus(padded, qidx, qpool, mode,
                                     lane_tile=LANE_TILE, raw=True))
        np.testing.assert_array_equal(
            assemble_raster_raw(header, raw),
            assemble_raster_slots(header, slots))


class TestKernelExtremeValues:
    """Adversarial coefficients/quantizers: exercises DEQUANT_CLAMP, the
    int32 wrap semantics inside the butterflies, and the sample clamp —
    regions real images never reach, where kernel/oracle agreement is only
    guaranteed by the shared spec (ops/specs.py)."""

    @pytest.mark.parametrize("mode_key", sorted(S.MODES))
    def test_extreme_matches_oracle(self, mode_key):
        from pim_jpeg_decoder_tpu.oracle.color import (chroma_subblock,
                                                       ycbcr_to_rgb)
        from pim_jpeg_decoder_tpu.oracle.idct import dequantize, idct_blocks

        mode = S.mode_for(mode_key)
        rng = np.random.default_rng(hash(mode_key) % 2**31)
        m = LANE_TILE
        coeffs = rng.integers(-32768, 32768, (m, mode.g, 64)).astype(np.int16)
        # A few all-extreme blocks on top of the uniform noise.
        coeffs[0] = 32767
        coeffs[1] = -32768
        qpool = rng.integers(1, 65536, (4, mode.g, 64)).astype(np.float32)
        qidx = (np.arange(m) % 4).astype(np.int32)

        got = np.asarray(decode_mcus(coeffs, qidx, qpool, mode,
                                     lane_tile=LANE_TILE))

        deq = dequantize(coeffs, qpool[qidx].astype(np.uint32))
        spat = idct_blocks(deq.reshape(m, mode.g, 8, 8))
        if mode.ncomp == 1:
            y = np.clip(spat[:, 0] + 128, 0, 255).astype(np.uint8)
            want = np.repeat(y.swapaxes(1, 2).reshape(m, 64, 1), 3, axis=2)
            np.testing.assert_array_equal(got[:, 0], want)
            return
        for s in range(mode.luma_slots):
            qv, qh = mode.luma_slot_pos(s)
            cb = chroma_subblock(spat[:, mode.luma_slots], qv, qh,
                                 mode.v, mode.h)
            cr = chroma_subblock(spat[:, mode.luma_slots + 1], qv, qh,
                                 mode.v, mode.h)
            want = (ycbcr_to_rgb(spat[:, s], cb, cr)
                    .swapaxes(1, 2).reshape(m, 64, 3))
            np.testing.assert_array_equal(got[:, s], want)


class TestDecodeRegion:
    @pytest.mark.parametrize("box", [(0, 0, 16, 16), (13, 27, 50, 40),
                                     (57, 35, 39, 93)])
    def test_matches_full_decode_slice(self, photo_image, box):
        from pim_jpeg_decoder_tpu.models.pipeline import (decode_bytes,
                                                          decode_region)
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        y0, x0, h, w = box
        full = decode_bytes(data)
        got = decode_region(data, y0, x0, h, w, lane_tile=128)
        np.testing.assert_array_equal(got, full[y0:y0 + h, x0:x0 + w])

    def test_bottom_right_edge(self, rng):
        from pim_jpeg_decoder_tpu.models.pipeline import (decode_bytes,
                                                          decode_region)
        img = rng.integers(0, 256, (37, 43, 3), np.uint8)  # partial MCUs
        data = encode_jpeg(img, quality=80, sampling="4:2:0")
        full = decode_bytes(data)
        got = decode_region(data, 21, 27, 16, 16, lane_tile=128)
        np.testing.assert_array_equal(got, full[21:37, 27:43])

    def test_rejects_out_of_bounds(self, photo_image):
        from pim_jpeg_decoder_tpu.models.pipeline import decode_region
        data = encode_jpeg(photo_image, quality=85)
        with pytest.raises(ValueError):
            decode_region(data, 0, 0, 10_000, 16)


class TestSixteenBitDqt:
    """A whole decode whose DQT segments are 16-bit (Pq=1) with entries up
    to 65535 stays bit-exact with the oracle.  The quant gather must be
    exact for every 16-bit value (a float matrix product may run in TF32
    on a GPU, which is exact only up to 2048)."""

    @pytest.mark.parametrize("sampling,grayscale", [
        ("4:4:4", False), ("4:2:2", False), ("4:4:0", False),
        ("4:2:0", False), ("4:4:4", True)])
    def test_decode_matches_oracle(self, photo_image, sampling, grayscale):
        from tests.helpers import widen_dqt

        img = photo_image[..., 0] if grayscale else photo_image
        data = widen_dqt(encode_jpeg(img, quality=90, sampling=sampling,
                                     grayscale=grayscale))
        header = scan_jpeg(data)
        assert all(t.precision == 1 for t in header.quant_tables.values())
        assert max(int(t.values.max())
                   for t in header.quant_tables.values()) == 65535
        got = TpuJpegDecoder(lane_tile=LANE_TILE, transport="rgb").decode(data)
        np.testing.assert_array_equal(got.rgb, decode_bytes_oracle(data).rgb)
