"""Progressive (SOF2) decode tests — golden comparison vs PIL/libjpeg.

Capability extension over the reference: the reference carries progressive
block-decode paths but can never complete progressive end-to-end
(reference: src/jpeg_scanner.cpp:425-430,521-704).  Here the full multi-scan
successive-approximation decode runs, feeding the same device transport layout
as baseline.
"""

import io

import numpy as np
import pytest
from PIL import Image

from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle


def pil_progressive(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", progressive=True, **kw)
    return buf.getvalue()


def pil_decode(data):
    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))


class TestProgressiveOracle:
    @pytest.mark.parametrize("quality", [50, 85, 95])
    def test_444_pixel_exact(self, photo_image, quality):
        data = pil_progressive(photo_image, quality=quality, subsampling=0)
        ours = decode_bytes_oracle(data)
        assert ours.header.progressive
        assert len(ours.header.scans) > 1
        np.testing.assert_array_equal(ours.rgb, pil_decode(data))

    def test_gray_pixel_exact(self, photo_image):
        gray = np.array(Image.fromarray(photo_image).convert("L"))
        data = pil_progressive(gray, quality=85)
        np.testing.assert_array_equal(
            decode_bytes_oracle(data).rgb, pil_decode(data))

    def test_noise_pixel_exact(self, noise_image):
        """Dense spectra exercise ZRL/EOB-run/refinement paths heavily."""
        data = pil_progressive(noise_image, quality=95, subsampling=0)
        np.testing.assert_array_equal(
            decode_bytes_oracle(data).rgb, pil_decode(data))

    def test_444_with_restart_markers(self, photo_image):
        data = pil_progressive(photo_image, quality=85, subsampling=0,
                               restart_marker_blocks=4)
        ours = decode_bytes_oracle(data)
        assert any(len(s.segment_offsets) > 1 for s in ours.header.scans)
        np.testing.assert_array_equal(ours.rgb, pil_decode(data))

    @pytest.mark.parametrize("sampling", [1, 2])
    def test_subsampled_close_to_pil(self, photo_image, sampling):
        """Nearest vs fancy upsampling (same divergence as baseline)."""
        data = pil_progressive(photo_image, quality=85, subsampling=sampling)
        ours = decode_bytes_oracle(data).rgb.astype(np.int32)
        pil = pil_decode(data).astype(np.int32)
        assert np.abs(ours - pil).mean() < 6.0
        # Uniform-chroma content: upsampling is irrelevant -> pixel exact.
        gray_rgb = np.stack([photo_image[..., 1]] * 3, axis=-1)
        data = pil_progressive(gray_rgb, quality=85, subsampling=sampling)
        np.testing.assert_array_equal(
            decode_bytes_oracle(data).rgb, pil_decode(data))

    def test_subsampled_with_restart_rows(self, photo_image):
        gray_rgb = np.stack([photo_image[..., 0]] * 3, axis=-1)
        data = pil_progressive(gray_rgb, quality=80, subsampling=2,
                               restart_marker_rows=2)
        np.testing.assert_array_equal(
            decode_bytes_oracle(data).rgb, pil_decode(data))

    @pytest.mark.parametrize("size", [(8, 8), (17, 9), (31, 33)])
    def test_odd_dimensions(self, rng, size):
        img = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        data = pil_progressive(img, quality=90, subsampling=0)
        ours = decode_bytes_oracle(data)
        assert ours.rgb.shape == (*size, 3)
        np.testing.assert_array_equal(ours.rgb, pil_decode(data))


class TestProgressiveTransport:
    def test_transport_layout_matches_baseline_content(self, photo_image):
        """Progressive and baseline encodings of the same pixels produce
        similar coefficient planes (sanity of the scan accumulation)."""
        prog = pil_progressive(photo_image, quality=90, subsampling=0)
        header = scan_jpeg(prog)
        coeffs = decode_progressive(header)
        assert coeffs.shape == (header.num_mcus, 3, 64)
        assert coeffs.dtype == np.int16
        # DC of a mid-gray-ish photo: nonzero for nearly all blocks.
        assert (coeffs[:, 0, 0] != 0).mean() > 0.9

    def test_progressive_through_engine(self, photo_image):
        """Progressive images decode through the full device pipeline."""
        from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
        data = pil_progressive(photo_image, quality=85, subsampling=0)
        engine = DecodeEngine(budget_mcus=512, lane_tile=128, keep_rgb=True)
        report = engine.decode_named_blobs([("p", data)])
        assert report.results[0].ok, report.results[0].error
        np.testing.assert_array_equal(report.results[0].rgb,
                                      decode_bytes_oracle(data).rgb)
        np.testing.assert_array_equal(report.results[0].rgb, pil_decode(data))


class TestProgressiveNative:
    """C++ progressive scan decode must match the Python reference exactly."""

    @pytest.fixture(autouse=True)
    def _need_native(self):
        from pim_jpeg_decoder_tpu.native import native_available
        if not native_available():
            pytest.skip("native decoder unavailable")

    @pytest.mark.parametrize("kw", [
        dict(quality=85, subsampling=0),
        dict(quality=75, subsampling=2),
        dict(quality=90, subsampling=1),
        dict(quality=85, subsampling=0, restart_marker_blocks=4),
        dict(quality=80, subsampling=2, restart_marker_rows=1),
    ])
    def test_native_matches_python(self, photo_image, kw):
        data = pil_progressive(photo_image, **kw)
        header = scan_jpeg(data)
        py = decode_progressive(header, use_native=False)
        cpp = decode_progressive(header, use_native=True)
        np.testing.assert_array_equal(py, cpp)

    def test_native_matches_python_gray(self, photo_image):
        gray = np.array(Image.fromarray(photo_image).convert("L"))
        data = pil_progressive(gray, quality=85)
        header = scan_jpeg(data)
        np.testing.assert_array_equal(
            decode_progressive(header, use_native=False),
            decode_progressive(header, use_native=True))

    def test_native_matches_python_noise(self, noise_image):
        data = pil_progressive(noise_image, quality=95, subsampling=0)
        header = scan_jpeg(data)
        np.testing.assert_array_equal(
            decode_progressive(header, use_native=False),
            decode_progressive(header, use_native=True))

    def test_scan_level_matches_image_level(self, photo_image):
        """The per-scan native export (semantic reference unit) agrees with
        the one-call image-level production path, scan by scan."""
        from pim_jpeg_decoder_tpu.native.binding import (
            decode_progressive_image_cpp,
            decode_progressive_scan_cpp,
        )
        from pim_jpeg_decoder_tpu.codec.tables import ZIGZAG

        data = pil_progressive(photo_image, quality=80, subsampling=2,
                               restart_marker_rows=1)
        header = scan_jpeg(data)
        comp_offset = np.zeros(3, np.int64)
        total = 0
        sizes = []
        for ci in range(header.ncomp):
            bwp, bhp = header.comp_blocks_padded(ci)
            sizes.append((bhp, bwp))
            comp_offset[ci] = total * 64
            total += bhp * bwp
        buf = np.zeros(total * 64, np.int32)
        for scan in header.scans:
            decode_progressive_scan_cpp(header, scan, buf, comp_offset)
        slots = header.slot_components()
        out = np.zeros((header.num_mcus, len(slots), 64), np.int16)
        for s, (ci, qv, qh) in enumerate(slots):
            c = header.components[ci]
            bhp, bwp = sizes[ci]
            plane = buf[int(comp_offset[ci]):
                        int(comp_offset[ci]) + bhp * bwp * 64]
            view = plane.reshape(bhp, bwp, 64)[qv::c.v, qh::c.h]
            out[:, s, ZIGZAG] = np.clip(
                view.reshape(header.num_mcus, 64), -32768, 32767)
        np.testing.assert_array_equal(
            out, decode_progressive_image_cpp(header))

    def test_truncated_raises(self, photo_image):
        data = pil_progressive(photo_image, quality=85, subsampling=0)
        header = scan_jpeg(data)
        header.scans[1].entropy_bytes = header.scans[1].entropy_bytes[:4]
        from pim_jpeg_decoder_tpu.codec.header import JpegError
        with pytest.raises(JpegError):
            decode_progressive(header, use_native=True)


class TestRandomTableProgressiveDifferential:
    """Native vs Python progressive decode on random tables and garbage
    scan payloads — dense coverage for the refine fast path (nonzero
    bitmask + run skipping) on table shapes real encoders never emit."""

    def test_random_progressive_scans(self):
        from pim_jpeg_decoder_tpu.codec.header import (
            Component,
            JpegError,
            JpegHeader,
            ScanData,
            ScanSpec,
        )
        from pim_jpeg_decoder_tpu.native import native_available
        from tests.test_native import TestRandomTableDifferential as T

        if not native_available():
            pytest.skip("native library unavailable")

        rng = np.random.default_rng(424242)
        agree = 0
        for trial in range(200):
            safe = rng.random() < 0.85
            make = (T._complete_huffman if safe else T._random_huffman)
            dc = make(rng, 0, 0)
            ac = make(rng, 1, 0)
            header = JpegHeader(
                width=int(rng.integers(8, 48)),
                height=int(rng.integers(8, 40)),
                progressive=True,
                components=[Component(0, 1, 1, 0, dc_id=0, ac_id=0)],
                dc_tables={0: dc},
                ac_tables={0: ac},
            )

            def payload():
                n = int(rng.integers(8, 200))
                return rng.integers(0, 256, n, np.uint8).tobytes()

            se = int(rng.integers(1, 64))
            al = int(rng.integers(0, 3))
            scans = [
                ScanData([0], [0], [0], ScanSpec(0, 0, 0, al + 1), 0,
                         payload(), (0,), [dc], [None]),
                ScanData([0], [0], [0], ScanSpec(0, 0, al + 1, al), 0,
                         payload(), (0,), [dc], [None]),
                ScanData([0], [0], [0], ScanSpec(1, se, 0, al), 0,
                         payload(), (0,), [None], [ac]),
                ScanData([0], [0], [0],
                         ScanSpec(1, se, al, max(0, al - 1)), 0,
                         payload(), (0,), [None], [ac]),
            ]
            header.scans = scans

            r_py = e_py = r_cc = e_cc = None
            try:
                r_py = decode_progressive(header, use_native=False)
            except JpegError as e:
                e_py = str(e)
            try:
                r_cc = decode_progressive(header, use_native=True)
            except JpegError as e:
                e_cc = str(e)
            if e_py is None and e_cc is None:
                np.testing.assert_array_equal(r_py, r_cc,
                                              err_msg=f"trial {trial}")
                agree += 1
            else:
                assert e_py is not None and e_cc is not None, (
                    f"trial {trial}: py={e_py!r} cpp={e_cc!r}")
        assert agree >= 8, f"only {agree} successful decodes compared"


class TestProgressiveComponentChains:
    """threads>1 partitions the scan script into per-component chains
    (VERDICT r4 item 1a): byte-identical output, correct engagement
    counters, and identical error reporting."""

    @pytest.fixture(autouse=True)
    def _need_native(self):
        from pim_jpeg_decoder_tpu.native import native_available
        if not native_available():
            pytest.skip("native decoder unavailable")

    @pytest.mark.parametrize("kw", [
        dict(quality=85, subsampling=0),
        dict(quality=75, subsampling=2),
        dict(quality=90, subsampling=1),
        dict(quality=85, subsampling=0, restart_marker_blocks=4),
        dict(quality=80, subsampling=2, restart_marker_rows=1),
    ])
    @pytest.mark.parametrize("threads", [2, 3, 8])
    def test_chains_match_serial(self, photo_image, kw, threads):
        data = pil_progressive(photo_image, **kw)
        header = scan_jpeg(data)
        serial = decode_progressive(header, threads=1)
        chained = decode_progressive(header, threads=threads)
        np.testing.assert_array_equal(chained, serial)

    def test_chains_match_serial_noise(self, noise_image):
        data = pil_progressive(noise_image, quality=95, subsampling=0)
        header = scan_jpeg(data)
        np.testing.assert_array_equal(
            decode_progressive(header, threads=3),
            decode_progressive(header, threads=1))

    def test_gray_single_chain(self, photo_image):
        """1-component images collapse to the serial path (no fan-out)."""
        from pim_jpeg_decoder_tpu.native.binding import segment_decode_stats
        gray = np.array(Image.fromarray(photo_image).convert("L"))
        data = pil_progressive(gray, quality=85)
        header = scan_jpeg(data)
        before = segment_decode_stats()
        out = decode_progressive(header, threads=4)
        after = segment_decode_stats()
        assert after["prog_serial_calls"] == before["prog_serial_calls"] + 1
        assert after["prog_parallel_calls"] == before["prog_parallel_calls"]
        np.testing.assert_array_equal(out, decode_progressive(header))

    def test_engagement_counters(self, photo_image):
        from pim_jpeg_decoder_tpu.native.binding import segment_decode_stats
        data = pil_progressive(photo_image, quality=85, subsampling=2)
        header = scan_jpeg(data)
        before = segment_decode_stats()
        decode_progressive(header, threads=3)
        after = segment_decode_stats()
        assert (after["prog_parallel_calls"]
                == before["prog_parallel_calls"] + 1)
        assert after["prog_chain_threads"] == before["prog_chain_threads"] + 3

    def test_two_thread_grouping(self, photo_image):
        """threads=2 on a 3-component image still matches serial (the
        chroma pair shares a chain)."""
        data = pil_progressive(photo_image, quality=85, subsampling=2)
        header = scan_jpeg(data)
        np.testing.assert_array_equal(
            decode_progressive(header, threads=2),
            decode_progressive(header, threads=1))

    def test_truncated_error_matches_serial(self, photo_image):
        """Chained decode reports the SAME error (message incl. scan and
        unit) as serial for a truncated stream."""
        from pim_jpeg_decoder_tpu.codec.header import JpegError
        data = pil_progressive(photo_image, quality=85, subsampling=0)
        bad = data[: int(len(data) * 0.7)]
        # Re-terminate so the scanner accepts it but a scan is short.
        bad += b"\xff\xd9"
        try:
            header = scan_jpeg(bad)
        except JpegError:
            pytest.skip("truncation landed in the marker structure")
        errs = []
        for threads in (1, 3):
            try:
                decode_progressive(header, threads=threads)
                errs.append(None)
            except JpegError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]

    def test_entropy_decode_forwards_threads(self, photo_image):
        """models.pipeline.entropy_decode passes threads to the
        progressive chains (the engine's dedicated-route policy)."""
        from pim_jpeg_decoder_tpu.models.pipeline import entropy_decode
        from pim_jpeg_decoder_tpu.native.binding import segment_decode_stats
        data = pil_progressive(photo_image, quality=85, subsampling=2)
        header = scan_jpeg(data)
        before = segment_decode_stats()
        entropy_decode(header, threads=3)
        after = segment_decode_stats()
        assert (after["prog_parallel_calls"]
                == before["prog_parallel_calls"] + 1)
