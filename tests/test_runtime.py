"""Runtime tests: batch packing, producer/consumer engine, CLI, profiler."""

import os

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.codec.entropy import decode_scan
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.io.bmp import read_bmp
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.runtime.batching import (
    BatchPacker,
    ModeRouter,
    PreparedImage,
    sort_by_size,
)
from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
from pim_jpeg_decoder_tpu.utils.profiling import StageTimers

LANE_TILE = 128


def prepared(img, name="img", **kw):
    data = encode_jpeg(img, **kw)
    header = scan_jpeg(data)
    return PreparedImage(name, header, decode_scan(header))


class TestBatchPacker:
    def test_greedy_fill_and_flush(self, photo_image):
        mode = S.mode_for((2, 2, 3))
        packer = BatchPacker(mode, budget_mcus=128, lane_tile=128)
        img = prepared(photo_image, sampling="4:2:0")   # 80 MCUs
        assert packer.add(img) is None                   # fits
        flushed = packer.add(img)                        # 160 > 128 -> flush
        assert flushed is not None
        assert len(flushed.images) == 1
        assert flushed.coeffs.shape == (128, 6, 64)
        final = packer.flush()
        assert final is not None and len(final.images) == 1

    def test_tail_batch_uses_smallest_bucket(self, photo_image):
        """A partial tail launch allocates the smallest covering bucket,
        not the full budget (transfer/decode waste)."""
        mode = S.mode_for((2, 2, 3))
        packer = BatchPacker(mode, budget_mcus=16384, lane_tile=512)
        img = prepared(photo_image, sampling="4:2:0")   # 80 MCUs
        packer.add(img)
        batch = packer.flush()
        assert batch.coeffs.shape[0] == 512              # not 16384
        # A fuller packer still allocates its bucket, capped at the budget.
        packer2 = BatchPacker(mode, budget_mcus=1024, lane_tile=512)
        for _ in range(12):                              # 960 MCUs
            packer2.add(img)
        b2 = packer2.flush()
        assert b2.coeffs.shape[0] == 1024

    def test_qidx_and_qpool(self, photo_image, noise_image):
        mode = S.mode_for((2, 2, 3))
        packer = BatchPacker(mode, budget_mcus=256)
        a = prepared(photo_image, name="a", sampling="4:2:0", quality=90)
        b = prepared(noise_image, name="b", sampling="4:2:0", quality=30)
        packer.add(a)
        packer.add(b)
        batch = packer.flush()
        na = a.header.num_mcus
        assert np.all(batch.qidx[:na] == 0)
        assert np.all(batch.qidx[na:na + b.header.num_mcus] == 1)
        # Different qualities -> different quant pools.
        assert not np.array_equal(batch.qpool[0], batch.qpool[1])
        np.testing.assert_array_equal(batch.coeffs[:na], a.coeffs)

    def test_mode_router_separates_modes(self, photo_image):
        router = ModeRouter(budget_mcus=4096)
        router.add(prepared(photo_image, sampling="4:2:0"))
        router.add(prepared(photo_image, sampling="4:4:4"))
        batches = router.flush_all()
        assert len(batches) == 2
        assert {b.mode.name for b in batches} == {"4:2:0", "4:4:4"}

    def test_sort_by_size(self, tmp_path, photo_image):
        big = tmp_path / "big.jpg"
        small = tmp_path / "small.jpg"
        big.write_bytes(encode_jpeg(photo_image, quality=95))
        small.write_bytes(encode_jpeg(photo_image, quality=10))
        assert sort_by_size([str(big), str(small)]) == [str(small), str(big)]


class TestDecodeEngine:
    def test_mixed_corpus_matches_oracle(self, photo_image, noise_image, rng):
        blobs = [
            ("a", encode_jpeg(photo_image, quality=90, sampling="4:2:0")),
            ("b", encode_jpeg(noise_image, quality=50, sampling="4:4:4")),
            ("c", encode_jpeg(photo_image, quality=75, sampling="4:2:2")),
            ("d", encode_jpeg(photo_image[:64, :56], quality=85,
                              sampling="4:2:0", restart_interval=3)),
            ("e", encode_jpeg(photo_image, quality=85, grayscale=True)),
        ]
        engine = DecodeEngine(budget_mcus=512, lane_tile=LANE_TILE,
                              prepare_threads=2, keep_rgb=True)
        report = engine.decode_named_blobs(blobs)
        assert report.ok_count == 5
        for (name, data), res in zip(blobs, report.results):
            assert res.ok, res.error
            want = decode_bytes_oracle(data).rgb
            np.testing.assert_array_equal(res.rgb, want, err_msg=name)

    def test_bad_file_skipped(self, photo_image):
        blobs = [
            ("good", encode_jpeg(photo_image, quality=85, sampling="4:2:0")),
            ("bad", b"not a jpeg at all"),
        ]
        engine = DecodeEngine(budget_mcus=256, lane_tile=LANE_TILE,
                              keep_rgb=True)
        report = engine.decode_named_blobs(blobs)
        assert report.results[0].ok
        assert not report.results[1].ok
        assert "SOI" in report.results[1].error

    def test_oversized_image_chunked_launch(self, rng):
        """Images bigger than the batch budget get a dedicated launch."""
        img = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
        data = encode_jpeg(img, quality=80, sampling="4:2:0")  # 130 MCUs
        engine = DecodeEngine(budget_mcus=128, lane_tile=LANE_TILE,
                              keep_rgb=True)
        report = engine.decode_named_blobs([("big", data)])
        assert report.results[0].ok, report.results[0].error
        np.testing.assert_array_equal(
            report.results[0].rgb, decode_bytes_oracle(data).rgb)

    def test_write_bmp_files(self, tmp_path, photo_image):
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        path = tmp_path / "img.jpg"
        path.write_bytes(data)
        engine = DecodeEngine(budget_mcus=256, lane_tile=LANE_TILE)
        report = engine.decode_paths([str(path)])
        out = report.results[0].out_path
        assert out == str(tmp_path / "img.bmp")
        rgb = read_bmp((tmp_path / "img.bmp").read_bytes())
        np.testing.assert_array_equal(rgb, decode_bytes_oracle(data).rgb)


class TestCli:
    def test_cli_end_to_end(self, tmp_path, photo_image, capsys):
        from pim_jpeg_decoder_tpu.cli import main
        p = tmp_path / "x.jpeg"
        p.write_bytes(encode_jpeg(photo_image, quality=85, sampling="4:2:0"))
        rc = main([str(p), "--batch-mcus", "256", "--lane-tile", "128"])
        assert rc == 0
        captured = capsys.readouterr()
        assert "Profiles:" in captured.out
        assert (tmp_path / "x.bmp").exists()

    def test_cli_reports_failures(self, tmp_path, capsys):
        from pim_jpeg_decoder_tpu.cli import main
        p = tmp_path / "bad.jpg"
        p.write_bytes(b"garbage")
        rc = main([str(p), "--batch-mcus", "256", "--lane-tile", "128"])
        assert rc == 1
        assert "SOI" in capsys.readouterr().err


class TestProfiler:
    def test_stage_accumulation(self):
        t = StageTimers()
        with t.stage("kernel"):
            pass
        with t.stage("kernel"):
            pass
        t.add("h2d", 0.5)
        snap = t.snapshot()
        assert snap["kernel"][1] == 2
        assert snap["h2d"] == (0.5, 1)
        report = t.report(extra={"Decoded files": "2/2"})
        assert "Profiles:" in report
        assert "Device kernel execution time" in report
        assert "Decoded files: 2/2" in report


class TestEngineSharding:
    def test_engine_uses_mesh_when_multichip(self, photo_image):
        """On the virtual 8-device mesh the engine shards batches and still
        matches the oracle bit-exactly."""
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs multiple devices")
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        engine = DecodeEngine(budget_mcus=1024, lane_tile=LANE_TILE,
                              keep_rgb=True)
        assert engine._mesh is not None
        assert engine.budget_mcus % (engine._mesh.devices.size * LANE_TILE) == 0
        report = engine.decode_named_blobs([("a", data)])
        assert report.results[0].ok
        np.testing.assert_array_equal(report.results[0].rgb,
                                      decode_bytes_oracle(data).rgb)


def test_duplicate_input_names(photo_image):
    """The same name twice must yield two independent results (results are
    keyed by input index, not name)."""
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine

    data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
    engine = DecodeEngine(budget_mcus=1024, lane_tile=128, keep_rgb=True)
    report = engine.decode_named_blobs([("same", data), ("same", data)])
    assert report.ok_count == 2
    assert len(report.results) == 2
    np.testing.assert_array_equal(report.results[0].rgb,
                                  report.results[1].rgb)


def test_chunked_decode_of_huge_image(rng):
    """Images beyond max_launch_mcus decode in MCU-row-aligned chunks and
    reassemble exactly (the reference rejects them: "Too high resolution")."""
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    img = rng.integers(0, 256, (250, 210, 3), dtype=np.uint8)  # 16x14 MCUs
    data = encode_jpeg(img, quality=80, sampling="4:2:0")      # 224 MCUs
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=1,
                       max_launch_mcus=128)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    report = engine.decode_named_blobs([("huge", data)])
    assert report.ok_count == 1, [r.error for r in report.results]
    assert len(report.results) == 1
    np.testing.assert_array_equal(report.results[0].rgb,
                                  decode_bytes_oracle(data).rgb)


def test_dedicated_route_engages_segment_parallel_decode(monkeypatch, rng):
    """A dedicated/banded-route DRI image entropy-decodes with restart-
    segment parallelism IN PRODUCTION (not just at the API level): the
    engine's prepare stage must reach the native threads>1 branch, and the
    output must equal the serial decode (SURVEY.md section 2 item 4)."""
    from pim_jpeg_decoder_tpu.native import binding

    if binding.load() is None:
        pytest.skip("native decoder unavailable")
    # Shrink the amortization floor so a test-sized image fans out, and
    # report many cores (the engine caps fan-out at the core count).
    monkeypatch.setattr(binding, "_MIN_MCUS_PER_THREAD", 8)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    img = rng.integers(0, 256, (250, 210, 3), dtype=np.uint8)  # 16x14 MCUs
    data = encode_jpeg(img, quality=80, sampling="4:2:0",
                       restart_interval=5)                     # 45 segments
    before = binding.segment_decode_stats()["parallel_calls"]
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=4,
                       max_launch_mcus=65536, num_devices=1)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    report = engine.decode_named_blobs([("dri", data)])
    assert report.ok_count == 1, [r.error for r in report.results]
    after = binding.segment_decode_stats()["parallel_calls"]
    assert after > before, "dedicated route decoded serially"
    np.testing.assert_array_equal(report.results[0].rgb,
                                  decode_bytes_oracle(data).rgb)


def test_dedicated_route_engages_progressive_chains(monkeypatch, rng):
    """A dedicated-route PROGRESSIVE image entropy-decodes with
    component-chain parallelism in production: the engine's prepare stage
    must reach the chained branch, and output must equal serial decode."""
    import io as _io

    from PIL import Image

    from pim_jpeg_decoder_tpu.native import binding

    if binding.load() is None:
        pytest.skip("native decoder unavailable")
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    img = rng.integers(0, 256, (250, 210, 3), dtype=np.uint8)  # 16x14 MCUs
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=85,
                              progressive=True, subsampling=2)
    data = buf.getvalue()
    before = binding.segment_decode_stats()["prog_parallel_calls"]
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=4,
                       max_launch_mcus=65536, num_devices=1)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    report = engine.decode_named_blobs([("prog", data)])
    assert report.ok_count == 1, [r.error for r in report.results]
    after = binding.segment_decode_stats()["prog_parallel_calls"]
    assert after > before, "dedicated route decoded progressive serially"
    np.testing.assert_array_equal(report.results[0].rgb,
                                  decode_bytes_oracle(data).rgb)


def test_ultrawide_image_tiles_within_launch_cap(rng):
    """A single MCU row wider than max_launch_mcus splits into column
    tiles — no launch exceeds the configured cap."""
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    img = rng.integers(0, 256, (16, 3200, 3), dtype=np.uint8)  # 1x200 MCUs
    data = encode_jpeg(img, quality=80, sampling="4:2:0")
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=1,
                       max_launch_mcus=128)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    report = engine.decode_named_blobs([("wide", data)])
    assert report.ok_count == 1, [r.error for r in report.results]
    np.testing.assert_array_equal(report.results[0].rgb,
                                  decode_bytes_oracle(data).rgb)


def test_jpeg_max_width_image_through_bmp_writer(tmp_path, rng):
    """The widest image JPEG can express (SOF dims are 16-bit, T.81 B.2.2:
    max 65,535 px) decodes in column tiles AND serializes through the BMP
    writer — the 'no size ceiling' claim holds end to end.  (>65,535 px
    cannot occur from a JPEG; the writer's BITMAPINFOHEADER fallback for
    such arrays is unit-tested in test_bmp.py.)"""
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    width = 65535                                  # 4096 MCU columns
    img = rng.integers(0, 256, (2, -(-width // 16), 3), dtype=np.uint8)
    img = np.repeat(np.repeat(img, 8, 0), 16, 1)[:, :width]  # [16, 65535, 3]
    data = encode_jpeg(img, quality=90, sampling="4:2:0")
    path = str(tmp_path / "wide.jpg")
    with open(path, "wb") as f:
        f.write(data)
    cfg = EngineConfig(budget_mcus=1024, lane_tile=128, prepare_threads=1,
                       max_launch_mcus=1024)
    engine = DecodeEngine(config=cfg)
    report = engine.decode_paths([path], write=True)
    assert report.ok_count == 1, [r.error for r in report.results]
    out = report.results[0].out_path
    np.testing.assert_array_equal(read_bmp(out),
                                  decode_bytes_oracle(data).rgb)


def test_engine_records_launch_stats(photo_image):
    """Launch geometry is collected per compiled device program (the
    reference's per-DPU launch counters)."""
    data = encode_jpeg(photo_image, quality=80, sampling="4:2:0")
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=1)
    engine = DecodeEngine(config=cfg)
    report = engine.decode_named_blobs([("a", data), ("b", data)])
    assert report.ok_count == 2
    assert sum(report.launch_stats.values()) >= 1
    (mode_key, m, lane_tile, transport, scale, wire, q) = next(
        iter(report.launch_stats))
    assert mode_key == (2, 2, 3)
    assert m % lane_tile == 0
    assert transport in ("rgb", "ycbcr")
    assert scale == 1
    assert wire in ("i8", "i16")
    assert q == cfg.max_images_per_batch  # packed batches pad the qpool
    # The Profiles block prints host stages only (device time comes from
    # a profiler trace).
    report.print_profile()


def test_engine_reports_init_line(photo_image, capsys):
    """The per-run init line (trace+compile attribution from per-geometry
    dispatch timings — the reference's initialization counter analogue)
    is always present when launches happened."""
    data = encode_jpeg(photo_image, quality=80, sampling="4:2:0")
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=1)
    engine = DecodeEngine(config=cfg)
    report = engine.decode_named_blobs([("a", data), ("b", data)])
    assert report.dispatch_times
    assert (sum(len(v) for v in report.dispatch_times.values())
            == sum(report.launch_stats.values()))
    report.print_profile()
    out = capsys.readouterr().out
    assert "Device program init (trace+compile," in out


class TestStagingFailureIsolation:
    """Staging errors are per-file failures attributed to the failing
    batch's OWN images (a flushed batch holds EARLIER images than the one
    whose add() triggered the flush), and the final flush is isolated
    like every other staging site."""

    def _engine(self):
        from pim_jpeg_decoder_tpu.utils.config import EngineConfig
        # num_devices=1: the virtual 8-device mesh would round the budget
        # up to 8*lane_tile and absorb all three images into one batch,
        # hiding the flush-on-add pattern this class exercises.
        cfg = EngineConfig(budget_mcus=128, lane_tile=128,
                           prepare_threads=1, num_devices=1)
        return DecodeEngine(keep_rgb=True, config=cfg)

    def _blob(self, rng):
        img = rng.integers(0, 256, (128, 128, 3), np.uint8)  # 64 MCUs 4:2:0
        return encode_jpeg(img, quality=80, sampling="4:2:0")

    def test_flush_failure_blames_flushed_batch_not_trigger(self, rng):
        engine = self._engine()
        calls = {"n": 0}
        orig = engine._stage_batch

        def flaky(batch, timers):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            return orig(batch, timers)

        engine._stage_batch = flaky
        # a + b fill the 128-MCU batch; adding c flushes it (staging of
        # that FIRST batch fails), c decodes via the final flush.
        blobs = [("a", self._blob(rng)), ("b", self._blob(rng)),
                 ("c", self._blob(rng))]
        report = engine.decode_named_blobs(blobs)
        by_name = {r.name: r for r in report.results}
        assert not by_name["a"].ok and "staging failed" in by_name["a"].error
        assert not by_name["b"].ok and "staging failed" in by_name["b"].error
        assert by_name["c"].ok, by_name["c"].error
        assert calls["n"] == 2

    def test_all_staging_fails_returns_full_report(self, rng):
        engine = self._engine()

        def always_fail(batch, timers):
            raise RuntimeError("device gone")

        engine._stage_batch = always_fail
        blobs = [(f"i{k}", self._blob(rng)) for k in range(3)]
        report = engine.decode_named_blobs(blobs)  # must not raise
        assert report.ok_count == 0
        assert all("staging failed" in r.error for r in report.results)


def test_prepare_window_handles_many_items_with_failures(rng):
    """The bounded prepare-submission window must process every item in
    order even when the corpus is larger than the window and some items
    fail to prepare."""
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig
    cfg = EngineConfig(budget_mcus=128, lane_tile=128, prepare_threads=2)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    blobs = []
    for k in range(14):  # > window = max(2*prepare_threads, 4)
        img = rng.integers(0, 256, (32, 32, 3), np.uint8)
        data = encode_jpeg(img, quality=80, sampling="4:2:0")
        if k % 5 == 2:
            data = data[: len(data) // 2]  # corrupt: prepare fails
        blobs.append((f"f{k}", data))
    report = engine.decode_named_blobs(blobs)
    assert len(report.results) == 14
    for k, res in enumerate(report.results):
        assert res.name == f"f{k}"
        if k % 5 == 2:
            assert not res.ok and res.error
        else:
            assert res.ok, res.error
            want = decode_bytes_oracle(blobs[k][1]).rgb
            np.testing.assert_array_equal(res.rgb, want)


def test_parallel_finish_failure_isolation(rng):
    """A finisher failure inside the finish pool is a per-file error; the
    batch's other images still complete (validate-and-skip parity)."""
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig
    cfg = EngineConfig(budget_mcus=512, lane_tile=128, prepare_threads=2,
                       num_devices=1)
    engine = DecodeEngine(keep_rgb=True, config=cfg)
    orig = engine._finish_image

    def flaky(img, off, raw, ycbcr, write, results):
        if img.name == "bad":
            raise RuntimeError("synthetic finisher failure")
        return orig(img, off, raw, ycbcr, write, results)

    engine._finish_image = flaky
    blobs = []
    for name in ("a", "bad", "c"):
        img = rng.integers(0, 256, (48, 48, 3), np.uint8)
        blobs.append((name, encode_jpeg(img, quality=80, sampling="4:2:0")))
    report = engine.decode_named_blobs(blobs)
    by_name = {r.name: r for r in report.results}
    assert by_name["a"].ok and by_name["c"].ok
    assert not by_name["bad"].ok
    assert "output failed" in by_name["bad"].error
    for nm in ("a", "c"):
        want = decode_bytes_oracle(dict(blobs)[nm]).rgb
        np.testing.assert_array_equal(by_name[nm].rgb, want)


def test_engine_engages_native_raster_path(rng, monkeypatch):
    """Guard against the silent-fallback class: the engine must hand the
    FULL (contiguous) launch buffer to the C++ raster fast path — a
    padded slice fails its contiguity gate and quietly routes every
    decode through the NumPy chain (found in review; this pins it)."""
    from pim_jpeg_decoder_tpu.native import binding as B
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    if B.load() is None:
        pytest.skip("native library unavailable")
    calls = {"n": 0}
    orig = B.raster_rgb_cpp

    def counting(*a, **kw):
        out = orig(*a, **kw)
        if out is not None:
            calls["n"] += 1
        return out

    monkeypatch.setattr(B, "raster_rgb_cpp", counting)
    blobs = [(f"i{k}", encode_jpeg(
        rng.integers(0, 256, (64, 80, 3), np.uint8),
        quality=85, sampling="4:4:4")) for k in range(3)]
    cfg = EngineConfig(budget_mcus=512, lane_tile=128, prepare_threads=2,
                       num_devices=1, transport="rgb")
    report = DecodeEngine(keep_rgb=True, config=cfg).decode_named_blobs(blobs)
    assert report.ok_count == 3
    assert calls["n"] == 3, "native raster path did not engage"
    for (name, d), r in zip(blobs, report.results):
        np.testing.assert_array_equal(r.rgb, decode_bytes_oracle(d).rgb)


def test_engine_write_uses_fused_ycbcr_bmp(tmp_path, photo_image):
    """The engine's BMP write path must reach the one-pass fused
    YCbCr->BMP serializer (not silently fall back to the two-pass raster
    route — the r3 silent-fallback bug class), and the file must equal
    the oracle's pixels."""
    from pim_jpeg_decoder_tpu.io import bmp as bmp_mod
    from pim_jpeg_decoder_tpu.native import native_available
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    if not native_available():
        pytest.skip("native library unavailable")
    data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
    path = str(tmp_path / "img.jpg")
    with open(path, "wb") as f:
        f.write(data)
    before = bmp_mod.fused_write_count()
    cfg = EngineConfig(budget_mcus=512, lane_tile=128, prepare_threads=1,
                       transport="ycbcr")
    engine = DecodeEngine(config=cfg)  # keep_rgb=False -> fused eligible
    report = engine.decode_paths([path], write=True)
    assert report.ok_count == 1, [r.error for r in report.results]
    assert bmp_mod.fused_write_count() > before, "fused path not engaged"
    np.testing.assert_array_equal(read_bmp(report.results[0].out_path),
                                  decode_bytes_oracle(data).rgb)
