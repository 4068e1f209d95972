"""A/B two entropy.cpp source variants with interleaved in-process timing.

Generalizes tools/pgo_ab.py's methodology (the only one that resolves
<30% deltas on this rig — CLAUDE.md "Measurement methodology") to source
experiments: build the repo source and a patched variant, load both .so
files, interleave timed corpus passes swapping ``binding._lib``, and
report medians.  Correctness gate first: the variant must decode the
whole corpus byte-identically to the repo build before any timing.

Usage: python tools/src_ab.py <variant.cpp> [reps] [--prog]
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = __file__.rsplit("/tools/", 1)[0]
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "pim_jpeg_decoder_tpu", "native", "entropy.cpp")
WORK = os.path.join(tempfile.gettempdir(), "pim_jpeg_decoder", "src_ab")
BASE_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def build(src: str, out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run(["g++", *BASE_FLAGS, src, "-o", out],
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
    variant_src = sys.argv[1]
    reps = int(sys.argv[2]) if len(sys.argv) > 2 and sys.argv[2].isdigit() \
        else 15
    prog = "--prog" in sys.argv

    base_so = os.path.join(WORK, "base.so")
    var_so = os.path.join(WORK, "variant.so")
    print("building ...", flush=True)
    build(SRC, base_so)
    build(variant_src, var_so)

    import numpy as np

    import bench
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import binding, decode_scan_native

    blobs = bench.make_corpus()
    headers = [scan_jpeg(d) for _, d in blobs]
    mp = sum(h.width * h.height for h in headers) / 1e6

    libs = {"base": load(base_so), "variant": load(var_so)}
    with binding._lock:
        binding._load_failed = False

    # Correctness gate: byte-identical output on the whole corpus.
    outs = {}
    for name, lib in libs.items():
        binding._lib = lib
        outs[name] = [decode_scan_native(h) for h in headers]
    for a, b in zip(outs["base"], outs["variant"]):
        if not np.array_equal(a, b):
            raise SystemExit("VARIANT DIVERGES FROM BASE — not timing it")
    print("correctness gate passed (corpus byte-identical)", flush=True)

    if prog:
        pheaders = bench.make_progressive_headers(blobs)
        pmp = sum(h.width * h.height for h in pheaders) / 1e6

    rates: dict = {k: [] for k in libs}
    prates: dict = {k: [] for k in libs}
    for rep in range(reps):
        for name, lib in libs.items():
            binding._lib = lib
            t0 = time.monotonic()
            for h in headers:
                decode_scan_native(h)
            rates[name].append(mp / (time.monotonic() - t0))
            if prog:
                from pim_jpeg_decoder_tpu.codec.progressive import (
                    decode_progressive,
                )
                t0 = time.monotonic()
                for h in pheaders:
                    decode_progressive(h)
                prates[name].append(pmp / (time.monotonic() - t0))
    for name in libs:
        r = sorted(rates[name])
        line = (f"{name:8s} median={statistics.median(r):7.1f} MP/s "
                f"min={r[0]:.1f} max={r[-1]:.1f}")
        if prog:
            line += f"  prog_median={statistics.median(prates[name]):.1f}"
        print(line)
    print(f"variant/base = "
          f"{statistics.median(rates['variant']) / statistics.median(rates['base']):.3f}")


if __name__ == "__main__":
    main()
