"""A/B: PGO-trained vs plain -O3 build of the native entropy decoder.

Builds the current entropy.cpp twice (plain, and -fprofile-use after a
training decode pass run in a subprocess), loads BOTH .so files into this
process, and interleaves timed corpus passes while swapping
``binding._lib`` — within-process interleaved comparison is the only
timing methodology that resolves <30% deltas on this rig (CLAUDE.md
"Measurement methodology").

Usage: python tools/pgo_ab.py [reps]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = __file__.rsplit("/tools/", 1)[0]
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "pim_jpeg_decoder_tpu", "native", "entropy.cpp")
WORK = os.path.join(tempfile.gettempdir(), "pim_jpeg_decoder", "pgo_ab")
BASE_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def build(out: str, extra: list[str]) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run(["g++", *BASE_FLAGS, *extra, SRC, "-o", out],
                   check=True, capture_output=True)


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn in ("pjt_decode_scan", "pjt_decode_segments",
               "pjt_decode_progressive_scan", "pjt_decode_progressive_image",
               "pjt_progressive_assemble", "pjt_ycbcr_to_rgb", "pjt_ycbcr_to_bmp_rows",
               "pjt_destuff", "pjt_compact_wire", "pjt_bmp_rows", "pjt_raster_rgb",
               "pjt_abi_version"):
        getattr(lib, fn).restype = ctypes.c_int32
    assert lib.pjt_abi_version() == 13
    return lib


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 15

    tag = hashlib.sha256(open(SRC, "rb").read()).hexdigest()[:16]
    prof_dir = os.path.join(WORK, "prof")
    gen_cache = os.path.join(WORK, "gen_cache")
    plain_so = os.path.join(WORK, "plain.so")
    pgo_so = os.path.join(WORK, "pgo.so")

    print("building plain + profile-generate ...", flush=True)
    build(plain_so, [])
    # The training subprocess resolves the .so by source hash from its
    # cache dir; the gcda files flush when that process exits.
    build(os.path.join(gen_cache, f"entropy_{tag}.so"),
          [f"-fprofile-generate={prof_dir}"])
    print("training (subprocess corpus pass) ...", flush=True)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "entropy_bench.py"),
         "2", "--prog"],
        check=True, capture_output=True,
        env=dict(os.environ, PIM_JPEG_TPU_CACHE=gen_cache))
    print("building profile-use ...", flush=True)
    build(pgo_so, [f"-fprofile-use={prof_dir}", "-fprofile-correction"])

    import bench
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import binding, decode_scan_native

    blobs = bench.make_corpus()
    headers = [scan_jpeg(d) for _, d in blobs]
    mp = sum(h.width * h.height for h in headers) / 1e6

    libs = {"plain": load(plain_so), "pgo": load(pgo_so)}
    rates: dict[str, list[float]] = {k: [] for k in libs}
    with binding._lock:
        binding._load_failed = False
    decode_scan_native(headers[0])  # settle any lazy init
    for rep in range(reps):
        for name, lib in libs.items():
            binding._lib = lib
            t0 = time.monotonic()
            for h in headers:
                decode_scan_native(h)
            rates[name].append(mp / (time.monotonic() - t0))
    for name in libs:
        r = sorted(rates[name])
        print(f"{name:6s} median={statistics.median(r):7.1f} MP/s "
              f"min={r[0]:.1f} max={r[-1]:.1f} over {reps} interleaved reps")
    delta = statistics.median(rates["pgo"]) / statistics.median(rates["plain"])
    print(f"pgo/plain = {delta:.3f}")


if __name__ == "__main__":
    main()
