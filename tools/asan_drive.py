"""AddressSanitizer drive for the native entropy decoder.

Builds ``native/entropy.cpp`` with ``-fsanitize=address``, loads it in
place of the production .so, and decodes adversarial streams: the
encoder corpus with truncations (baseline/DRI/gray/progressive),
random-canonical-table garbage (incl. wide 11..15-bit magnitudes and
fast-phase-engaging lengths), and the deterministic worst-case-block
shape (single 16-bit codes, DC 11 + 63x AC 15) truncated across every
byte of the dangerous remaining-byte window.  Any out-of-bounds access
aborts with an ASan report.

This is the memory-safety complement to tools/fuzz.py's differential
property: the guarded fast path's byte-budget arithmetic
(docs/entropy_fast_path.md) asserts reads stay in bounds; ASan checks
the assertion directly.  Validated against the pre-fix kBlockSlack=232
build: prong 3 reports the heap over-read at FastState::refill exactly.

Usage: python tools/asan_drive.py [seed] [iters] [--ubsan]   (re-execs
itself under LD_PRELOAD=libasan.so; ~2-4 min for the default 250 iters).
--ubsan builds with -fsanitize=undefined instead: this found (and now
guards against regressing) the signed-left-shift/wraparound UB in the
progressive successive-approximation arithmetic, fixed via
shl32/wrap_add32.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

REPO = __file__.rsplit("/tools/", 1)[0]
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "pim_jpeg_decoder_tpu", "native", "entropy.cpp")
WORK = os.path.join(tempfile.gettempdir(), "pim_jpeg_decoder", "asan")
SO = os.path.join(WORK, "entropy_asan.so")


def _librt(name: str) -> str:
    out = subprocess.run(["g++", f"-print-file-name=lib{name}.so"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _reexec_under_sanitizer() -> None:
    """Build the sanitized .so and re-exec this script with the sanitizer
    runtime preloaded (it must load before python for a dlopen'd lib)."""
    ubsan = "--ubsan" in sys.argv
    san = "undefined" if ubsan else "address"
    os.makedirs(WORK, exist_ok=True)
    subprocess.run(
        ["g++", "-O1", "-g", f"-fsanitize={san}",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
         "-march=native", "-std=c++17", "-shared", "-fPIC", SRC, "-o", SO],
        check=True, capture_output=True)
    env = dict(os.environ,
               LD_PRELOAD=_librt("ubsan" if ubsan else "asan"),
               ASAN_OPTIONS="detect_leaks=0",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
               PJT_ASAN_CHILD="1")
    os.execve(sys.executable, [sys.executable, *sys.argv], env)


def main() -> None:
    if os.environ.get("PJT_ASAN_CHILD") != "1":
        _reexec_under_sanitizer()

    import numpy as np

    from pim_jpeg_decoder_tpu.native import binding

    lib = ctypes.CDLL(SO)
    for fn in ("pjt_decode_scan", "pjt_decode_segments",
               "pjt_decode_progressive_scan",
               "pjt_decode_progressive_image", "pjt_progressive_assemble",
               "pjt_ycbcr_to_rgb", "pjt_ycbcr_to_bmp_rows", "pjt_destuff", "pjt_compact_wire",
               "pjt_bmp_rows", "pjt_raster_rgb", "pjt_abi_version"):
        getattr(lib, fn).restype = ctypes.c_int32
    assert lib.pjt_abi_version() == 13
    with binding._lock:
        binding._lib = lib
        binding._load_failed = False

    import io

    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
    from pim_jpeg_decoder_tpu.codec.header import (
        Component,
        HuffmanTableSpec,
        JpegError,
        JpegHeader,
    )
    from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native.binding import decode_scan_cpp

    args = [a for a in sys.argv[1:] if a != "--ubsan"]
    rng = np.random.default_rng(int(args[0]) if args else 0)
    iters = int(args[1]) if len(args) > 1 else 250
    n_done = 0

    # 1. Encoder corpus + truncations.
    for _ in range(iters):
        h = int(rng.integers(8, 120))
        w = int(rng.integers(8, 120))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if rng.random() < 0.25:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=75,
                                      progressive=True,
                                      subsampling=int(rng.integers(0, 3)))
            data = buf.getvalue()
        else:
            data = encode_jpeg(
                img, quality=int(rng.integers(30, 98)),
                sampling=str(rng.choice(
                    ["4:4:4", "4:2:2", "4:4:0", "4:2:0"])),
                restart_interval=int(rng.choice([0, 0, 2, 5])))
        if rng.random() < 0.4 and len(data) > 4:
            data = data[: int(rng.integers(2, len(data)))]
        try:
            header = scan_jpeg(data)
            if header.progressive:
                decode_progressive(header)
            else:
                decode_scan_cpp(header,
                                threads=int(rng.choice([1, 1, 4])))
        except JpegError:
            pass
        n_done += 1

    # 2. Random-canonical-table garbage streams.
    def make_table(table_class, table_id):
        if rng.random() < 0.6:  # complete via tree splitting
            depths = [1, 1]
            target = int(rng.integers(4, 40))
            while len(depths) < target:
                j = int(rng.integers(0, len(depths)))
                if depths[j] >= 16:
                    continue
                d = depths.pop(j)
                depths += [d + 1, d + 1]
            counts = np.zeros(16, np.uint8)
            for d in depths:
                counts[d - 1] += 1
            total = len(depths)
        else:  # sparse canonical
            counts = np.zeros(16, np.uint8)
            code = 0
            total = 0
            for l in range(1, 17):
                cap = (1 << l) - code
                n = (0 if cap <= 0 or total >= 162
                     else int(rng.choice([0, 0, 1, 2, 3])))
                n = max(0, min(n, cap - (1 if l < 16 else 0),
                               162 - total))
                counts[l - 1] = n
                total += n
                code = (code + n) << 1
            if total == 0:
                counts[0] = 1
                total = 1
        if table_class == 0:
            syms = rng.integers(0, 16, total).astype(np.uint8)
        else:
            runs = rng.integers(0, 16, total)
            sizes = rng.choice([0, 1, 2, 3, 4, 9, 10, 12, 15], total)
            syms = (runs << 4 | sizes).astype(np.uint8)
        return HuffmanTableSpec(table_id, table_class, counts, syms)

    for _ in range(iters * 2):
        if rng.random() < 0.5:
            comps = [Component(0, 1, 1, 0, dc_id=0, ac_id=0)]
        else:
            v, hh = int(rng.integers(1, 3)), int(rng.integers(1, 3))
            comps = [Component(0, hh, v, 0, dc_id=0, ac_id=0),
                     Component(1, 1, 1, 0, dc_id=1, ac_id=1),
                     Component(2, 1, 1, 0, dc_id=1, ac_id=1)]
        header = JpegHeader(
            width=int(rng.integers(8, 64)),
            height=int(rng.integers(8, 48)),
            components=comps,
            dc_tables={t: make_table(0, t) for t in range(2)},
            ac_tables={t: make_table(1, t) for t in range(2)},
            restart_interval=int(rng.choice([0, 0, 0, 2, 5])),
        )
        n = int(rng.integers(300, 4000) if rng.random() < 0.4
                else rng.integers(16, 400))
        payload = rng.integers(0, 256, n, np.uint8)
        if rng.random() < 0.3:
            payload[rng.random(n) < 0.5] = 0
        header.entropy_bytes = payload.tobytes()
        if header.restart_interval:
            segs = -(-header.num_mcus // header.restart_interval)
            offs = sorted(int(x)
                          for x in rng.integers(0, n, segs - 1))
            header.segment_offsets = tuple([0] + offs)
        else:
            header.segment_offsets = (0,)
        try:
            decode_scan_cpp(header)
        except JpegError:
            pass
        n_done += 1

    # 3. Deterministic worst-case-block streams: DC 11 + 63x AC 15 with
    # 16-bit codes (1980 bits/block), final block truncated across every
    # byte of the guard window.
    def onecode16(symbol, table_class):
        counts = np.zeros(16, np.uint8)
        counts[15] = 1
        return HuffmanTableSpec(0, table_class, counts,
                                np.array([symbol], np.uint8))

    bits = []
    for _ in range(8):
        bits.extend([0] * 16
                    + [(0x7FF >> i) & 1 for i in range(10, -1, -1)])
        for _ in range(63):
            bits.extend([0] * 16
                        + [(0x7FFF >> i) & 1 for i in range(14, -1, -1)])
    while len(bits) % 8:
        bits.append(1)
    full = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))
    for cut in range(1940, len(full) + 1):
        header = JpegHeader(
            width=64, height=8,
            components=[Component(0, 1, 1, 0, dc_id=0, ac_id=0)],
            dc_tables={0: onecode16(11, 0)},
            ac_tables={0: onecode16(0x0F, 1)},
            restart_interval=0,
        )
        header.entropy_bytes = full[:cut]
        header.segment_offsets = (0,)
        try:
            decode_scan_cpp(header)
        except JpegError:
            pass
        n_done += 1

    # 4. The remaining native surfaces: destuff on adversarial byte
    # soups, compact_wire at the int8 boundary, ycbcr_to_rgb across all
    # sampling geometries (incl. ragged right/bottom MCU edges).
    from pim_jpeg_decoder_tpu.native.binding import (
        compact_wire_cpp,
        destuff_cpp,
        ycbcr_to_rgb_cpp,
    )
    for _ in range(iters):
        n = int(rng.integers(0, 600))
        soup = rng.integers(0, 256, n, np.uint8)
        if rng.random() < 0.5:
            soup[rng.random(n) < 0.3] = 0xFF  # marker/stuffing heavy
        try:
            destuff_cpp(soup.tobytes(), int(rng.integers(0, n + 1)),
                        stop_at_marker=bool(rng.random() < 0.5))
        except JpegError:
            pass
        lo, hi = (-128, 128) if rng.random() < 0.5 else (-300, 300)
        coeffs = rng.integers(lo, hi, (int(rng.integers(1, 64)), 6, 64),
                              np.int16)
        compact_wire_cpp(coeffs)
        v, hh = int(rng.integers(1, 3)), int(rng.integers(1, 3))
        ncomp = int(rng.choice([1, 3]))
        if ncomp == 1:
            v = hh = 1
        g = v * hh + (2 if ncomp == 3 else 0)
        rows, cols = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        m_total = rows * cols + int(rng.integers(0, 8))  # padded tail
        planes = rng.integers(0, 256, (g, 64, m_total), np.uint8)
        height = int(rng.integers(1, rows * v * 8 + 1))
        width = int(rng.integers(1, cols * hh * 8 + 1))
        ycbcr_to_rgb_cpp(planes, 0, v, hh, ncomp, rows, cols,
                         height, width)
        from pim_jpeg_decoder_tpu.native.binding import raster_rgb_cpp
        nsc = int(rng.choice([8, 4, 2, 1]))
        raw = rng.integers(0, 256, (3, v * hh, nsc * nsc, m_total),
                           np.uint8)
        raster_rgb_cpp(raw, v, hh, nsc, rows, cols,
                       int(rng.integers(1, rows * v * nsc + 1)),
                       int(rng.integers(1, cols * hh * nsc + 1)))
        n_done += 4

    san = "UBSAN" if "--ubsan" in sys.argv else "ASAN"
    print(f"{san}-CLEAN {n_done} decodes")


if __name__ == "__main__":
    main()
