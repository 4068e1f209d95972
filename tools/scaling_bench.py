"""Multi-host scaling-efficiency harness (BASELINE.md: >=90% at N>=2 hosts).

Each process decodes its strided shard of the corpus against its local
chips (whole-image sharding: zero cross-host data dependencies — see
pim_jpeg_decoder_tpu/parallel/multihost.py), then process 0 aggregates
megapixels and wall time over the network and reports throughput + scaling
efficiency vs the single-process baseline.

Run single-process (baseline; --cpu pins the CPU backend so the number
is comparable to the CPU-backend multi-process simulation below):
    python tools/scaling_bench.py --cpu

Run N processes on one machine (CPU backend, simulates N hosts):
    python tools/scaling_bench.py --num-processes 2 --process-id 0 &
    python tools/scaling_bench.py --num-processes 2 --process-id 1 &
    wait

On a real cluster each host runs the same command with its own process id
and the coordinator's address (or zero args under Slurm / Open MPI, whose
variables jax.distributed reads itself).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time


def _early_thread_caps() -> None:
    """Split the machine's cores between the simulated hosts BEFORE numpy
    loads: OpenBLAS reads OMP/OPENBLAS/MKL_NUM_THREADS at library load,
    so setting them inside main() (after ``import numpy``) is a no-op and
    the simulation would measure core thrash, not scaling."""
    n = 0
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--num-processes" and i + 1 < len(argv):
            n = int(argv[i + 1])
            break
        if a.startswith("--num-processes="):
            n = int(a.split("=", 1)[1])
            break
    if n > 1:
        per_proc = max(1, (os.cpu_count() or 8) // n)
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ.setdefault(var, str(per_proc))


_early_thread_caps()

import numpy as np  # noqa: E402  (after the BLAS thread caps, see above)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_corpus(n: int):
    from PIL import Image

    rng = np.random.default_rng(7)
    blobs = []
    for i in range(n):
        small = rng.integers(0, 256, (24, 32, 3), np.uint8)
        img = np.array(Image.fromarray(small).resize((500, 375),
                                                     Image.BILINEAR))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=75,
                                  subsampling=2)
        blobs.append((f"img{i}", buf.getvalue()))
    return blobs


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--coordinator", default="localhost:9876")
    parser.add_argument("--images", type=int, default=32)
    parser.add_argument("--baseline-mps", type=float, default=None,
                        help="single-process MP/s for efficiency reporting "
                             "(measure it with --cpu so it matches the "
                             "CPU-backend simulation)")
    parser.add_argument("--cpu", action="store_true",
                        help="pin the CPU backend for the single-process "
                             "baseline run")
    args = parser.parse_args()

    multi = args.num_processes is not None and args.num_processes > 1
    if multi:
        # CPU-backend multi-process simulation of a multi-host pod.  The
        # per-host BLAS thread caps were applied at module import (before
        # numpy loaded) — see _early_thread_caps.
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    else:
        import jax
        if args.cpu:
            # The --baseline-mps denominator for the CPU simulation must
            # itself be a CPU number, not one from an accelerator.
            jax.config.update("jax_platforms", "cpu")

    from pim_jpeg_decoder_tpu.parallel.multihost import partition_paths
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine

    corpus = make_corpus(args.images)
    # Sort by size before the strided split so per-host megapixels balance
    # (see partition_paths docstring).
    corpus.sort(key=lambda kv: (len(kv[1]), kv[0]))
    names = [n for n, _ in corpus]
    mine = set(partition_paths(names))
    shard = [(n, b) for n, b in corpus if n in mine]

    engine = DecodeEngine(budget_mcus=4096, lane_tile=256)
    # Warm up with the FULL shard: bucketed batch allocation means the tail
    # batch has its own compiled shape, and a fresh XLA compile inside the
    # timed region would measure compilation, not decode.
    engine.decode_named_blobs(shard)

    t0 = time.monotonic()
    report = engine.decode_named_blobs(shard)
    dt = time.monotonic() - t0
    local_mp = report.total_megapixels
    if report.ok_count != len(shard):
        errs = [(r.name, r.error) for r in report.results if not r.ok]
        raise SystemExit(f"decode failures on shard: {errs[:4]}")

    if multi:
        import jax
        from jax.experimental import multihost_utils
        payload = np.array([local_mp, dt], np.float64)
        stats = multihost_utils.process_allgather(payload)
        # The ONLY application data that crosses DCN in this design: the
        # final per-host (megapixels, wall) metadata allgather.  Pixels,
        # coefficients and files never leave their host (whole-image
        # sharding) — the structural basis of the >=90% scaling claim.
        dcn_bytes = int(stats.nbytes)
        total_mp = float(stats[:, 0].sum())
        wall = float(stats[:, 1].max())     # makespan across hosts
        if jax.process_index() == 0:
            mps = total_mp / wall
            per_host_mp = stats[:, 0]
            out = {
                "metric": "multi-host decode throughput",
                "hosts": args.num_processes,
                "value": round(mps, 2),
                "unit": "MP/s",
                # Per-host megapixel balance of the sorted strided split
                # (min/max): partition_paths must keep hosts evenly loaded
                # or the makespan, not coordination, caps efficiency.
                "mp_balance": round(float(per_host_mp.min())
                                    / float(per_host_mp.max()), 3),
                "dcn_bytes": dcn_bytes,
                # This simulation runs N "hosts" on ONE machine's cores, so
                # per-host compute is 1/N of the baseline's: aggregate
                # throughput >= the single-process number demonstrates zero
                # coordination overhead (whole-image sharding crosses hosts
                # only for the final metadata allgather).  Real multi-host
                # efficiency requires real per-host resources.
                "note": "CPU simulation shares one machine's cores",
            }
            if args.baseline_mps:
                out["scaling_efficiency"] = round(
                    mps / (args.baseline_mps * args.num_processes), 3)
            print(json.dumps(out))
    else:
        print(json.dumps({
            "metric": "single-process decode throughput",
            "hosts": 1,
            "value": round(local_mp / dt, 2),
            "unit": "MP/s",
        }))


if __name__ == "__main__":
    main()
