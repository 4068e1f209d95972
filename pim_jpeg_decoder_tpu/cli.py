"""Command-line driver: ``python -m pim_jpeg_decoder_tpu <img1> <img2> ...``

Equivalent of the reference's ``main`` (reference: src/decoder_host.cpp:352-451):
argv file list, sort by size, two-stage pipelined decode, BMP written next to
each input (extension replaced with .bmp, reference: :330), and a "Profiles:"
stage report at exit (reference: :379-394).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pim-jpeg-decoder-tpu",
        description="GPU-accelerated baseline JPEG -> BMP decoder",
    )
    parser.add_argument("files", nargs="+", help="JPEG files to decode")
    parser.add_argument("--batch-mcus", type=int, default=None,
                        help="MCUs per device batch (static shape)")
    parser.add_argument("--lane-tile", type=int, default=None,
                        help="MCU padding granule of device batches")
    parser.add_argument("--prepare-threads", type=int, default=None,
                        help="host entropy-decode threads")
    parser.add_argument("--scale", type=int, default=None,
                        choices=(1, 2, 4, 8),
                        help="decode at 1/scale resolution "
                             "(reduced IDCT, like djpeg -scale)")
    parser.add_argument("--transport", default=None,
                        choices=("auto", "rgb", "ycbcr"),
                        help="device->host transport: ycbcr halves D2H "
                             "bytes for subsampled modes (default auto)")
    parser.add_argument("--wire", default=None, choices=("auto", "i16"),
                        help="host->device coefficient wire: auto ships "
                             "int8 when the batch fits, halving H2D bytes "
                             "(default auto)")
    parser.add_argument("--no-sort", action="store_true",
                        help="do not sort inputs by file size")
    parser.add_argument("--no-write", action="store_true",
                        help="decode only; skip BMP output")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the profile report")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a jax.profiler trace to DIR "
                             "(device-side per-kernel timing)")
    args = parser.parse_args(argv)

    import os
    if args.profile:
        os.environ["PIM_JPEG_TPU_PROFILE"] = args.profile

    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    engine = DecodeEngine(config=EngineConfig.from_env(
        budget_mcus=args.batch_mcus,
        lane_tile=args.lane_tile,
        prepare_threads=args.prepare_threads,
        scale=args.scale,
        transport=args.transport,
        wire=args.wire,
    ))
    if not args.quiet:
        # Allocation banner (reference: src/decoder_host.cpp:362
        # "N dpus are allocated").
        import jax
        devs = jax.local_devices()
        print(f"{len(devs)} {devs[0].platform} device(s) allocated")
    report = engine.decode_paths(args.files, write=not args.no_write,
                                 sort=not args.no_sort)

    failures = 0
    for r in report.results:
        if not r.ok:
            failures += 1
            print(f"{r.name}: {r.error}", file=sys.stderr)
        elif r.out_path and not args.quiet:
            print(f"{r.name} -> {r.out_path}")
    if not args.quiet:
        report.print_profile()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
