"""Standalone host-entropy-decode microbench (no accelerator needed).

Builds the same q75 corpus as bench.py, then times decode_scan_native
(single thread) over several repetitions.  Used to iterate on
native/entropy.cpp; the number printed here is the same quantity bench.py
reports as host_entropy_mps.

Usage: python tools/entropy_bench.py [reps] [--prog]
"""

from __future__ import annotations

import statistics
import sys
import time

REPO = __file__.rsplit("/tools/", 1)[0]
sys.path.insert(0, REPO)


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 5
    import bench

    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import decode_scan_native

    blobs = bench.make_corpus()
    headers = [scan_jpeg(d) for _, d in blobs]
    mp = sum(h.width * h.height for h in headers) / 1e6

    decode_scan_native(headers[0])  # build/load the .so outside the timer
    rates = []
    for _ in range(reps):
        t0 = time.monotonic()
        for h in headers:
            decode_scan_native(h)
        rates.append(mp / (time.monotonic() - t0))
    print(f"host_entropy_mps: median={statistics.median(rates):.1f} "
          f"min={min(rates):.1f} max={max(rates):.1f} over {reps} reps, "
          f"{len(blobs)} images, {mp:.1f} MP/pass")

    if "--prog" in sys.argv:
        from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive

        # The same fixture set bench.py times as host_progressive_mps.
        pheaders = bench.make_progressive_headers(blobs)
        pmp = sum(h.width * h.height for h in pheaders) / 1e6
        decode_progressive(pheaders[0])
        prates = []
        for _ in range(reps):
            t0 = time.monotonic()
            for h in pheaders:
                decode_progressive(h)
            prates.append(pmp / (time.monotonic() - t0))
        print(f"host_progressive_mps: "
              f"median={statistics.median(prates):.1f} "
              f"min={min(prates):.1f} max={max(prates):.1f}")

        # Component-chain fan-out (threads=3): ~1.0x or below on a 1-core
        # rig (chains re-decode the DC scans); the multi-core lever —
        # re-measure here on real multi-core hosts (docs/deployment.md).
        crates = []
        for _ in range(reps):
            t0 = time.monotonic()
            for h in pheaders:
                decode_progressive(h, threads=3)
            crates.append(pmp / (time.monotonic() - t0))
        import os
        print(f"host_progressive_chains_mps: "
              f"median={statistics.median(crates):.1f} "
              f"min={min(crates):.1f} max={max(crates):.1f} "
              f"(threads=3, host_cores={os.cpu_count()})")


if __name__ == "__main__":
    main()
