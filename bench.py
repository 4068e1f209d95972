"""Benchmark harness: Megapixels/sec/device JPEG decode on an NVIDIA GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, ...extras}
and exits non-zero without it when JAX finds no GPU.

Primary value: device decode throughput — the fused dequantize + integer
IDCT + chroma upsample + BT.601 program with device-resident buffers, i.e.
the device's decode capability when embedded in an ML input pipeline.
Extras report TWO e2e regimes: ``e2e_device_mps`` = bytes ->
device-resident [B,H,W,3] batch (ML input pipeline; no RGB D2H) and
``e2e_mps`` = JPEG->BMP via full RGB D2H (median of 3), plus the
PIL/libjpeg single-thread baseline on the same corpus and an on-device
bit-exactness sweep vs the NumPy oracle covering
every sampling mode x wire transport x scaled/region/progressive/DRI path.

The reference publishes no numbers (BASELINE.md); vs_baseline is measured
against PIL/libjpeg single-thread CPU decode of the same corpus.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

ILSVRC = "/root/reference/ILSVRC2012_val_00000001.JPEG"
NUM_IMAGES = 48
KERNEL_BATCH_MCUS = 16384
KERNEL_REPS = 132


def synth_scene(rng, w: int, h: int) -> np.ndarray:
    """One distinct synthetic scene: gradient base + multi-octave blobs +
    texture + geometry.  Every call draws fresh structure (octave mix,
    palette, shape layout), so coefficient statistics vary image to image
    instead of being 47 rolls of one photograph."""
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        a, b = rng.uniform(-1, 1, 2)
        img[..., c] = rng.uniform(60, 200) + 70 * a * xx / w + 70 * b * yy / h
    # Low/mid-frequency structure: upsampled noise octaves.
    for cell, amp in ((int(rng.integers(24, 64)), rng.uniform(15, 45)),
                      (int(rng.integers(6, 16)), rng.uniform(5, 25))):
        small = rng.normal(0, 1, (h // cell + 2, w // cell + 2, 3))
        small = (small - small.min()) / (np.ptp(small) + 1e-6) * 255
        up = np.array(Image.fromarray(small.astype(np.uint8)).resize(
            (w, h), Image.BILINEAR), np.float32)
        img += amp * (up - 128) / 128 * rng.uniform(20, 60)
    # Geometry: a few hard-edged rectangles/disks (ringing content).
    for _ in range(int(rng.integers(2, 7))):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(h // 16, h // 3), rng.integers(w // 16, w // 3)
        color = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            img[max(0, cy - ry):cy + ry, max(0, cx - rx):cx + rx] = (
                0.6 * img[max(0, cy - ry):cy + ry,
                          max(0, cx - rx):cx + rx] + 0.4 * color)
        else:
            mask = ((yy - cy) ** 2 / max(ry, 1) ** 2
                    + (xx - cx) ** 2 / max(rx, 1) ** 2) <= 1.0
            img[mask] = 0.5 * img[mask] + 0.5 * color
    # Fine texture at a drawn amplitude (sensor-noise analogue).
    img += rng.normal(0, rng.uniform(1.5, 9.0), (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_corpus() -> list:
    """ImageNet-like corpus: 500x375 4:2:0 q75 baseline JPEGs with
    DISTINCT content per image (1 real photo + synthetic scenes)."""
    from PIL import Image

    blobs = []
    if os.path.exists(ILSVRC):
        with open(ILSVRC, "rb") as f:
            blobs.append(("ilsvrc", f.read()))
    rng = np.random.default_rng(42)
    while len(blobs) < NUM_IMAGES:
        img = synth_scene(rng, 500, 375)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=75,
                                  subsampling=2)
        blobs.append((f"img{len(blobs)}", buf.getvalue()))
    return blobs


# Heterogeneous hardware corpus: (name, w, h, coding) with coding a PIL
# subsampling id, "gray", "prog" (progressive SOF2), or "dri" (restart
# intervals — routes the segment-parallel prepare branch).
MIXED_SPECS = [
    ("mixed_2048x1536_420", 2048, 1536, 2),
    ("mixed_1600x1200_422", 1600, 1200, 1),
    ("mixed_1280x960_420_prog", 1280, 960, "prog"),   # >= 1 MP progressive
    ("mixed_1152x864_420_dri", 1152, 864, "dri"),     # ~1 MP, 54 segments
    ("mixed_1024x768_420", 1024, 768, 2),
    ("mixed_800x600_gray", 800, 600, "gray"),
    ("mixed_640x480_422", 640, 480, 1),
    ("mixed_513x389_420", 513, 389, 2),       # odd dims, partial MCUs
    ("mixed_333x257_444", 333, 257, 0),
    ("mixed_160x120_420", 160, 120, 2),
    ("mixed_97x61_gray", 97, 61, "gray"),
]


def make_mixed_corpus(small_only: bool = False) -> list:
    """Mixed-size/mixed-mode corpus: heterogeneous dims (2048x1536 down to
    97x61, odd sizes) across 4:2:0 / 4:2:2 / 4:4:4 / grayscale plus a >=1 MP
    progressive and a DRI member (r5) — exercises the engine's FULL routing
    surface on the device: partial bucketed batches, dedicated launches,
    multi-image qpools, the progressive prepare path, and the
    segment-parallel DRI branch (the reference's batcher exists precisely
    for mixed corpora, reference: src/decoder_host.cpp:118-184)."""
    from PIL import Image

    rng = np.random.default_rng(1234)
    out = []
    for name, w, h, sub in MIXED_SPECS:
        if small_only and w * h > 700 * 600:
            continue
        img = synth_scene(rng, w, h)
        buf = io.BytesIO()
        if sub == "gray":
            Image.fromarray(img).convert("L").save(
                buf, format="JPEG", quality=80)
        elif sub == "prog":
            Image.fromarray(img).save(buf, format="JPEG", quality=80,
                                      subsampling=2, progressive=True)
        elif sub == "dri":
            Image.fromarray(img).save(buf, format="JPEG", quality=80,
                                      subsampling=2, restart_marker_rows=1)
        else:
            Image.fromarray(img).save(buf, format="JPEG", quality=80,
                                      subsampling=sub)
        out.append((name, buf.getvalue()))
    return out


def bench_pil(blobs) -> float:
    from PIL import Image

    t0 = time.monotonic()
    mp = 0.0
    for _, data in blobs:
        img = Image.open(io.BytesIO(data))
        img = np.asarray(img.convert("RGB"))
        mp += img.shape[0] * img.shape[1] / 1e6
    return mp / (time.monotonic() - t0)


def bench_host_entropy(blobs) -> float:
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import decode_scan_native

    headers = [scan_jpeg(d) for _, d in blobs]
    t0 = time.monotonic()
    mp = 0.0
    for h in headers:
        decode_scan_native(h)
        mp += h.width * h.height / 1e6
    return mp / (time.monotonic() - t0)


N_ENTROPY_THREADS = 4


def bench_host_entropy_mt(blobs, threads: int = N_ENTROPY_THREADS) -> float:
    """Aggregate entropy throughput with the corpus fanned across N decode
    threads (the engine's prepare-pool shape; the C++ decoder releases the
    GIL).  On a many-core host this is the measured point behind
    docs/deployment.md's per-core sizing; on a one-core host the honest
    expectation is ~1.0x the serial number — the measurement then pins the
    absence of contention overhead (allocator, GIL re-acquisition, shared
    pools), not a speedup.  host_cores in the JSON line says which."""
    from concurrent.futures import ThreadPoolExecutor

    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import decode_scan_native

    headers = [scan_jpeg(d) for _, d in blobs]
    mp = sum(h.width * h.height for h in headers) / 1e6
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.monotonic()
        list(pool.map(decode_scan_native, headers))
        dt = time.monotonic() - t0
    return mp / dt


def bench_dri_segment_parallel(threads: int = N_ENTROPY_THREADS) -> tuple:
    """(serial_mps, parallel_mps) entropy decode of ONE large DRI image via
    restart-segment fan-out — the engine's dedicated/banded prepare route
    (runtime/engine.py:_prepare).  ~1.0x expected on a one-core host (a
    regression guard for dispatch/merge overhead); the speedup case is
    many-core deployment."""
    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import decode_scan_native

    rng = np.random.default_rng(77)
    img = synth_scene(rng, 2048, 1536)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=75, subsampling=2,
                              restart_marker_rows=1)   # 96 segments
    header = scan_jpeg(buf.getvalue())
    # Pillow <11 silently ignores restart_marker_rows; without segments the
    # "parallel" column would measure serial decode.
    assert header.restart_interval > 0, (
        "encoder produced no restart intervals (Pillow too old?)")
    mp = header.width * header.height / 1e6
    serial, parallel = [], []
    for _ in range(5):
        t0 = time.monotonic()
        decode_scan_native(header, threads=1)
        serial.append(mp / (time.monotonic() - t0))
        t0 = time.monotonic()
        decode_scan_native(header, threads=threads)
        parallel.append(mp / (time.monotonic() - t0))
    return statistics.median(serial), statistics.median(parallel)


def bench_host_finishers(blobs) -> tuple:
    """(host_color_mps, host_bmp_mps, host_fused_write_mps): the BMP
    path's per-core host finishers — AVX2 upsample+BT.601 from the YCbCr
    wire layout, the native BMP row serializer, and the r4 one-pass fused
    wire-planes->BMP serializer the engine's write path uses (all C++,
    GIL released; see docs/deployment.md budget table)."""
    import statistics as _st

    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.io.bmp import _bmp_scaffold, encode_bmp
    from pim_jpeg_decoder_tpu.native import native_available
    from pim_jpeg_decoder_tpu.native.binding import (ycbcr_to_bmp_rows_cpp,
                                                     ycbcr_to_rgb_cpp)

    if not native_available():
        return 0.0, 0.0, 0.0  # pure-Python fallback host: stays honest

    h = scan_jpeg(blobs[0][1])
    mp = h.width * h.height / 1e6
    rng = np.random.default_rng(0)
    g = 6  # 4:2:0 slot count
    rows420, cols420 = -(-h.height // 16), -(-h.width // 16)
    planes = rng.integers(0, 256, (g, 64, rows420 * cols420), np.uint8)
    rgb = rng.integers(0, 256, (h.height, h.width, 3), np.uint8)
    color, bmp, fused = [], [], []
    for _ in range(5):
        t0 = time.monotonic()
        for _ in range(20):
            ycbcr_to_rgb_cpp(planes, 0, 2, 2, 3, rows420, cols420,
                             h.height, h.width)
        color.append(20 * mp / (time.monotonic() - t0))
        t0 = time.monotonic()
        for _ in range(20):
            encode_bmp(rgb)
        bmp.append(20 * mp / (time.monotonic() - t0))
        t0 = time.monotonic()
        for _ in range(20):
            buf, rows, row_bytes = _bmp_scaffold(h.height, h.width)
            ycbcr_to_bmp_rows_cpp(planes, 0, 2, 2, 3, rows420, cols420,
                                  h.height, h.width, row_bytes, rows)
        fused.append(20 * mp / (time.monotonic() - t0))
    return _st.median(color), _st.median(bmp), _st.median(fused)


def make_progressive_headers(blobs, n: int = 12):
    """Progressive (SOF2) re-encodes of the corpus head, parsed — the
    fixture set for host_progressive_mps (shared with
    tools/entropy_bench.py --prog so both report the same corpus)."""
    import io

    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg

    headers = []
    for _, d in blobs[:n]:
        img = Image.open(io.BytesIO(d)).convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", progressive=True, quality=75,
                 subsampling=2)
        headers.append(scan_jpeg(buf.getvalue()))
    return headers


def bench_progressive(blobs) -> tuple:
    """(serial_mps, chains_mps, pil_mps): host progressive (SOF2) decode
    throughput — capability beyond the reference, so it gets its own
    numbers.  ``chains_mps`` fans the per-component scan chains across
    threads (expected ~1.0x on a one-core host — the multi-core lever,
    docs/entropy_fast_path.md); ``pil_mps`` is PIL/libjpeg decoding the
    SAME progressive fixtures single-thread (the like-for-like baseline:
    bench's pil_single_thread_mps is PIL on the BASELINE corpus)."""
    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive

    headers = make_progressive_headers(blobs)
    mp = sum(h.width * h.height for h in headers) / 1e6
    serial, chains = [], []
    decode_progressive(headers[0])  # build/load outside the timer
    for _ in range(5):
        t0 = time.monotonic()
        for h in headers:
            decode_progressive(h)
        serial.append(mp / (time.monotonic() - t0))
        t0 = time.monotonic()
        for h in headers:
            decode_progressive(h, threads=3)
        chains.append(mp / (time.monotonic() - t0))
    # PIL like-for-like: re-encode exactly as make_progressive_headers.
    pil_rates = []
    pdatas = []
    for _, d in blobs[:len(headers)]:
        img = Image.open(io.BytesIO(d)).convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", progressive=True, quality=75,
                 subsampling=2)
        pdatas.append(buf.getvalue())
    for _ in range(5):
        t0 = time.monotonic()
        for d in pdatas:
            np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
        pil_rates.append(mp / (time.monotonic() - t0))
    return (statistics.median(serial), statistics.median(chains),
            statistics.median(pil_rates))


def bench_device_kernel() -> tuple:
    """Device-resident decode throughputs with replication bands:
    ``((rgb_min, rgb_med, rgb_max), (ycbcr_min, ycbcr_med, ycbcr_max))``
    MP/s over 7 timed windows of KERNEL_REPS back-to-back 16,384-MCU 4:2:0
    launches each, timed by the host clock up to ``block_until_ready`` of
    the last launch (one device executes launches in order).  Inputs
    rotate over 8 buffers so no launch reads a cache-resident input.
    """
    import functools

    import jax

    from pim_jpeg_decoder_tpu.ops import specs as S
    from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus_impl
    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache

    ensure_compilation_cache()
    mode = S.mode_for((2, 2, 3))
    m = KERNEL_BATCH_MCUS
    rng = np.random.default_rng(0)
    n_rot = 8
    coeff_rot = [jax.device_put(
        rng.integers(-200, 200, (m, mode.g, 64)).astype(np.int16))
        for _ in range(n_rot)]
    qidx = jax.device_put((np.arange(m) % 16).astype(np.int32))
    qpool_rot = [jax.device_put(
        rng.integers(1, 64, (16, mode.g, 64)).astype(np.float32))
        for _ in range(n_rot)]

    mp_per_launch = m * mode.mcu_px_h * mode.mcu_px_w / 1e6
    out = []
    for ycbcr in (False, True):
        fn = jax.jit(functools.partial(decode_mcus_impl, mode=mode,
                                       raw=not ycbcr, ycbcr=ycbcr))
        for c, qp in zip(coeff_rot, qpool_rot):
            fn(c, qidx, qp).block_until_ready()          # compile + warm
        rates = []
        for _ in range(7):
            t0 = time.perf_counter()
            for i in range(KERNEL_REPS):
                last = fn(coeff_rot[i % n_rot], qidx, qpool_rot[i % n_rot])
            last.block_until_ready()
            rates.append(mp_per_launch * KERNEL_REPS
                         / (time.perf_counter() - t0))
        rates.sort()
        out.append((rates[0], statistics.median(rates), rates[-1]))
    return tuple(out)


def bench_e2e(blobs) -> tuple:
    """(median, best) MP/s over 3 runs of the full BMP-path pipeline.

    Median is the headline; best is reported too, labeled, as the
    low-variance bound.
    """
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine

    engine = DecodeEngine(budget_mcus=16384, prepare_threads=8)
    # Warmup: compile every mode present.
    engine.decode_named_blobs(blobs[:2])
    rates = []
    stages = {}
    for run in range(3):
        # Rotate the decode order per run, so no run re-issues the batches
        # of the one before.
        order = blobs[run:] + blobs[:run]
        t0 = time.monotonic()
        report = engine.decode_named_blobs(order)
        dt = time.monotonic() - t0
        assert report.ok_count == len(order), [
            r.error for r in report.results if not r.ok]
        rates.append(report.total_megapixels / dt)
        # Per-stage seconds of the latest run (the engine's own timers;
        # producer/consumer stages overlap, so they exceed wall time).
        stages = {f"{k}_s": round(v, 3)
                  for k, (v, _) in report.timers.snapshot().items()}
        stages["wall_s"] = round(dt, 3)
    return statistics.median(rates), max(rates), stages


def largest_same_size_group(blobs):
    """Largest same-(size, mode) group of a corpus: (datas, total_mp).
    Shared by the device/stream e2e benches (one grouping-key contract)."""
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg

    groups = {}
    for _, d in blobs:
        h = scan_jpeg(d)
        groups.setdefault((h.width, h.height, h.mode_key), []).append(
            (d, h.width * h.height / 1e6))
    batch = max(groups.values(), key=len)
    return [d for d, _ in batch], sum(m for _, m in batch)


def bench_e2e_device(blobs) -> float:
    """Deployment-honest ML-input-pipeline e2e: bytes -> [B, H, W, 3] ON CHIP.

    Measures models.input_pipeline.decode_same_size_batch — host marker scan
    + C++ entropy decode + coefficient H2D + fused device decode — with the
    decoded batch staying device-resident (no RGB D2H; a small dependent
    slice is fetched to force completion).  This is the number the BMP-path e2e (which pays full RGB D2H
    + BMP assembly) cannot represent.  Median of 3 runs, batch rotated per
    run so no level of the stack can serve a cached result.
    """
    from pim_jpeg_decoder_tpu.models.input_pipeline import (
        decode_same_size_batch,
    )

    # Largest same-(size, mode) group of the corpus (ilsvrc may differ).
    datas, mp = largest_same_size_group(blobs)

    def run(rot: int) -> float:
        rotated = datas[rot:] + datas[:rot]
        t0 = time.monotonic()
        out, _ = decode_same_size_batch(rotated, prepare_threads=8)
        # Force completion: fetch a sparse dependent slice (few KB).
        np.asarray(out[:, ::97, ::97, :])
        return mp / (time.monotonic() - t0)

    run(1)  # warmup: compile
    rates = [run(r) for r in (2, 3, 4)]

    # Stage decomposition: ONE instrumented pass with blocking stage
    # boundaries, so the split between host and device stages is on record
    # (the throughput runs above stay fully async).  Mirrors the
    # reference's per-stage profile (reference: src/decoder_host.cpp:379-394).
    from pim_jpeg_decoder_tpu.utils.profiling import StageTimers

    timers = StageTimers()
    out, _ = decode_same_size_batch(datas, prepare_threads=8, timers=timers)
    with timers.stage("fetch"):
        np.asarray(out[:, ::97, ::97, :])
    stages = {f"{k}_s": round(v, 3)
              for k, (v, _) in timers.snapshot().items()}
    return statistics.median(rates), stages


def bench_e2e_mixed(mixed) -> float:
    """Mixed-size/mode BMP-path throughput: the engine's routing surface
    (partial buckets, dedicated launches, multi-image qpools) timed on the
    device.  Median of 3 runs."""
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine

    engine = DecodeEngine(budget_mcus=16384, prepare_threads=8)
    engine.decode_named_blobs(mixed)  # warmup: compile every geometry
    rates = []
    stages = {}
    for run in range(3):
        # Rotate per run so batch packing (and thus launch inputs) differ.
        order = mixed[run:] + mixed[:run]
        t0 = time.monotonic()
        report = engine.decode_named_blobs(order)
        dt = time.monotonic() - t0
        assert report.ok_count == len(order), [
            r.error for r in report.results if not r.ok]
        rates.append(report.total_megapixels / dt)
        stages = {f"{k}_s": round(v, 3)
                  for k, (v, _) in report.timers.snapshot().items()}
        stages["wall_s"] = round(dt, 3)
    return statistics.median(rates), stages


def bench_e2e_stream(blobs) -> float:
    """Streaming ML-input-pipeline e2e (iter_decode_batches): host entropy
    decode of batch N+1 overlaps device decode of batch N.  Same
    device-resident accounting as bench_e2e_device; median of 3."""
    from pim_jpeg_decoder_tpu.models.input_pipeline import (
        iter_decode_batches,
    )

    datas, mp = largest_same_size_group(blobs)
    nb = max(2, len(datas) // 12)
    size = -(-len(datas) // nb)
    batches = [datas[i:i + size] for i in range(0, len(datas), size)]

    def run(rot: int) -> float:
        rotated = [b[rot:] + b[:rot] for b in batches]
        t0 = time.monotonic()
        for out, _ in iter_decode_batches(rotated, prefetch=2):
            np.asarray(out[:, ::97, ::97, :])  # force real completion
        return mp / (time.monotonic() - t0)

    run(1)  # warmup
    rates = []
    t0 = time.monotonic()
    for r in (2, 3, 4):
        rates.append(run(r))
        if time.monotonic() - t0 > 120:
            break

    # One instrumented pass for the stage split (see bench_e2e_device).
    from pim_jpeg_decoder_tpu.utils.profiling import StageTimers

    timers = StageTimers()
    for out, _ in iter_decode_batches(batches, prefetch=2, timers=timers):
        with timers.stage("fetch"):
            np.asarray(out[:, ::97, ::97, :])
    stages = {f"{k}_s": round(v, 3)
              for k, (v, _) in timers.snapshot().items()}
    return statistics.median(rates), stages


def make_variety_corpus() -> list:
    """Fixtures covering every mode x transport x coding path for the
    on-hardware bit-exactness sweep: 4:4:4 / 4:2:2 / 4:4:0 / 4:2:0 /
    grayscale, restart intervals (DRI), and progressive (SOF2)."""
    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 30, 3), np.uint8)
    img = np.array(Image.fromarray(img).resize((168, 120), Image.BILINEAR))

    out = []
    for name, sub in (("444", 0), ("422", 1), ("420", 2)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=80,
                                  subsampling=sub)
        out.append((f"variety_{name}", buf.getvalue()))
    buf = io.BytesIO()
    Image.fromarray(img).convert("L").save(buf, format="JPEG", quality=80)
    out.append(("variety_gray", buf.getvalue()))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=80,
                              subsampling=2, progressive=True)
    out.append(("variety_progressive", buf.getvalue()))
    # 4:4:0 and DRI need the in-repo encoder (PIL can't emit them).
    out.append(("variety_440", encode_jpeg(img, sampling="4:4:0")))
    out.append(("variety_420_dri",
                encode_jpeg(img, sampling="4:2:0", restart_interval=3)))
    return out


def check_bit_exact(blobs, variety, mixed) -> dict:
    """On-hardware bit-exactness sweep vs the NumPy oracle.

    Every corpus + variety + mixed-size image through the engine in BOTH
    wire transports (auto -> YCbCr where it saves bytes, rgb -> forced
    RGB), plus the scaled (reduced-IDCT) kernel for every mode x scale,
    region decode, and a BANDED (chunked) decode with max_launch_mcus
    forced below the image's MCU count — so each kernel variant,
    transport, and the _split_bands multi-launch route is asserted
    bit-exact on the device.  Returns
    {"ok", "images", "checks", "failures": [names]}.
    """
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.models.pipeline import (
        decode_region,
        decode_scaled,
    )
    from pim_jpeg_decoder_tpu.oracle.decoder import (
        decode_bytes_oracle,
        decode_scaled_oracle,
    )
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    all_imgs = list(blobs) + list(variety) + list(mixed)
    oracle = {name: decode_bytes_oracle(data).rgb for name, data in all_imgs}
    failures = []
    checks = 0

    # Banded (chunked) decode on the device: force the launch cap below the
    # image's MCU count so _split_bands + accumulator paste run as real
    # multi-launch decodes (the "no size ceiling" path the reference
    # rejects outright, reference: src/decoder_host.cpp:146-149).
    banded_pool = [(n, d, scan_jpeg(d).num_mcus) for n, d in mixed]
    banded_pool = [t for t in banded_pool if t[2] > 1200]
    if banded_pool:
        bname, bdata, n_mcus = max(banded_pool, key=lambda t: t[2])
        cap = 512
        engine_b = DecodeEngine(keep_rgb=True, config=EngineConfig(
            budget_mcus=16384, max_launch_mcus=cap))
        rep = engine_b.decode_named_blobs([(bname, bdata)])
        checks += 1
        res = rep.results[0]
        launches = sum(rep.launch_stats.values())
        expect_min = -(-n_mcus // cap)
        if not (res.ok and np.array_equal(res.rgb, oracle[bname])
                and launches >= min(2, expect_min)):
            failures.append(
                f"{bname}[banded launches={launches} ok={res.ok}]")

    # auto transport over EVERYTHING; the forced-RGB transport pass over
    # the variety set only — RGB-vs-YCbCr divergence would be per sampling
    # mode (device program), not per image, and the variety set covers
    # every mode, so a full-corpus RGB pass would only re-pay its 2x D2H
    # bytes for no extra coverage.
    for transport, imgs in (("auto", all_imgs), ("rgb", list(variety))):
        engine = DecodeEngine(keep_rgb=True, config=EngineConfig(
            budget_mcus=16384, transport=transport))
        report = engine.decode_named_blobs(imgs)
        for (name, _), res in zip(imgs, report.results):
            checks += 1
            if not res.ok or not np.array_equal(res.rgb, oracle[name]):
                failures.append(f"{name}[{transport}]")

    for name, data in variety:
        for scale in (2, 4, 8):
            checks += 1
            got = decode_scaled(data, scale)
            if not np.array_equal(got, decode_scaled_oracle(data, scale)):
                failures.append(f"{name}[scale={scale}]")

    # Region decode: bit-identical to the same slice of the oracle raster.
    name, data = blobs[0]
    checks += 1
    got = decode_region(data, 33, 17, 160, 240)
    if not np.array_equal(got, oracle[name][33:193, 17:257]):
        failures.append(f"{name}[region]")

    return {"ok": not failures, "images": len(all_imgs), "checks": checks,
            "failures": failures}


def main() -> None:
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if device["platform"] != "gpu":
        # A device metric is never measured on another backend.
        print(f"bench.py: JAX platform is {device['platform']!r}, not "
              f"'gpu'", file=sys.stderr)
        sys.exit(2)

    blobs = make_corpus()
    variety = make_variety_corpus()
    mixed = make_mixed_corpus()

    kernel_band, ycbcr_band = bench_device_kernel()
    kernel_mps, ycbcr_kernel_mps = kernel_band[1], ycbcr_band[1]
    e2e_device_mps, e2e_device_stages = bench_e2e_device(blobs)
    e2e_stream_mps, e2e_stream_stages = bench_e2e_stream(blobs)
    e2e_mps, e2e_best_mps, e2e_stages = bench_e2e(blobs)
    e2e_mixed_mps, e2e_mixed_stages = bench_e2e_mixed(mixed)
    entropy_mps = bench_host_entropy(blobs)
    entropy_mt_mps = bench_host_entropy_mt(blobs)
    seg_serial_mps, seg_parallel_mps = bench_dri_segment_parallel()
    progressive_mps, prog_chains_mps, pil_prog_mps = bench_progressive(blobs)
    color_mps, bmp_mps, fused_mps = bench_host_finishers(blobs)
    pil_mps = bench_pil(blobs)
    exact = check_bit_exact(blobs, variety, mixed)

    result = {
        "metric": "JPEG decode throughput per device (fused dequant+IDCT+color, device-resident)",
        "value": round(kernel_mps, 1),
        "unit": "MP/s",
        "vs_baseline": round(kernel_mps / pil_mps, 2),
        "device": device,
        "kernel_mps_band": [round(v, 1) for v in kernel_band],
        "ycbcr_kernel_mps": round(ycbcr_kernel_mps, 1),
        "ycbcr_kernel_mps_band": [round(v, 1) for v in ycbcr_band],
        "e2e_device_mps": round(e2e_device_mps, 1),
        "e2e_stream_mps": round(e2e_stream_mps, 1),
        "e2e_mps": round(e2e_mps, 1),
        "e2e_best_mps": round(e2e_best_mps, 1),
        "e2e_mixed_mps": round(e2e_mixed_mps, 1),
        "e2e_device_stages": e2e_device_stages,
        "e2e_stream_stages": e2e_stream_stages,
        "e2e_stages": e2e_stages,
        "e2e_mixed_stages": e2e_mixed_stages,
        "e2e_vs_pil": round(e2e_mps / pil_mps, 2),
        "host_entropy_mps": round(entropy_mps, 1),
        "host_entropy_mps_nt": round(entropy_mt_mps, 1),
        "host_entropy_nt": N_ENTROPY_THREADS,
        "host_cores": os.cpu_count(),
        "seg_parallel_mps": round(seg_parallel_mps, 1),
        "seg_parallel_serial_mps": round(seg_serial_mps, 1),
        "host_progressive_mps": round(progressive_mps, 1),
        "host_progressive_chains_mps": round(prog_chains_mps, 1),
        "pil_progressive_mps": round(pil_prog_mps, 1),
        "host_color_mps": round(color_mps, 1),
        "host_bmp_mps": round(bmp_mps, 1),
        "host_fused_write_mps": round(fused_mps, 1),
        "pil_single_thread_mps": round(pil_mps, 1),
        "bit_exact_vs_oracle": exact["ok"],
        "bit_exact_images": exact["images"],
        "bit_exact_checks": exact["checks"],
        "corpus": "distinct-scenes-v3",
        "corpus_images": len(blobs),
        "mixed_images": len(mixed),
    }
    if exact["failures"]:
        result["bit_exact_failures"] = exact["failures"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
