"""The decode engine: producer/consumer pipeline around the device decode.

Runtime equivalent of the reference's two host threads
(``mcu_prepare`` producer + ``offloading`` consumer joined by a mutex/cv
queue, reference: src/decoder_host.cpp:35-38,101-350,364-365):

  prepare pool (N threads)   read + marker scan + C++ entropy decode
        |                    (GIL released in native code -> true parallelism,
        v                     vs the reference's single preparer thread)
  ModeRouter / BatchPacker   greedy fixed-budget packing per sampling mode
        |
        v  bounded queue (backpressure = the reference's cv-guarded queue)
  consumer thread            H2D -> fused device decode -> D2H -> raster
                             assembly -> BMP write

Per-file failures are recorded and skipped, matching the reference's
validate-and-skip behavior (reference: src/decoder_host.cpp:120-123).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.io.bmp import write_bmp
from pim_jpeg_decoder_tpu.models.pipeline import (
    assemble_raster_raw,
    assemble_raster_raw_scaled,
    assemble_raster_ycbcr,
    entropy_decode,
    output_path,
)
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus
from pim_jpeg_decoder_tpu.runtime.batching import (
    Batch,
    ModeRouter,
    PreparedImage,
    compact_wire,
)
from pim_jpeg_decoder_tpu.utils.log import logger
from pim_jpeg_decoder_tpu.utils.profiling import StageTimers


@dataclasses.dataclass
class _BandAccumulator:
    """Assembly state for one over-max_launch image decoded in chunks."""
    name: str
    uid: int
    header: "JpegHeader"
    raster: np.ndarray          # [H, W, 3], bands pasted as they finish
    remaining: int              # bands still in flight
    failed: bool = False


@dataclasses.dataclass
class FileResult:
    name: str
    ok: bool
    out_path: Optional[str] = None
    rgb: Optional[np.ndarray] = None
    error: Optional[str] = None
    megapixels: float = 0.0


@dataclasses.dataclass
class EngineReport:
    results: List[FileResult]
    timers: StageTimers
    # Launch geometry -> count (the reference's per-DPU launch counters,
    # reference: src/decoder_host.cpp:388-391).
    launch_stats: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    # Launch geometry -> per-dispatch wall durations (first call of a new
    # geometry pays JAX trace + XLA compile), for the init line below.
    dispatch_times: Dict[tuple, list] = dataclasses.field(
        default_factory=dict)

    @property
    def ok_count(self) -> int:
        return sum(r.ok for r in self.results)

    @property
    def total_megapixels(self) -> float:
        return sum(r.megapixels for r in self.results if r.ok)

    def print_profile(self) -> None:
        """Print the Profiles block (reference: decoder_host.cpp:379-394).

        Per-kernel device time comes from a ``jax.profiler`` trace of the
        run (CLI ``--profile DIR``), not from this block.
        """
        print(self.timers.report(extra={
            "Decoded files": f"{self.ok_count}/{len(self.results)}",
            "Total megapixels": f"{self.total_megapixels:.2f}",
        }))
        if self.dispatch_times:
            # Mirror of the reference's per-run "initialization" counter
            # (reference: src/decoder_dpu.c:85-89, decoder_host.cpp:388):
            # here init = JAX trace + XLA compile, paid once per launch
            # geometry (first dispatch of each key; warm dispatches are
            # async and take ~ms).  Cold = first dispatch exceeded the
            # warm-dispatch median by >100 ms.
            import statistics
            warm = [d for ds in self.dispatch_times.values()
                    for d in ds[1:]]
            typical = statistics.median(warm) if warm else 0.0
            init_s = 0.0
            cold = 0
            for ds in self.dispatch_times.values():
                excess = ds[0] - typical
                if excess > max(0.1, 5 * typical):
                    init_s += excess
                    cold += 1
            print(f" - Device program init (trace+compile, {cold} cold "
                  f"geometries): {init_s:.6f} (s)")


class DecodeEngine:
    """High-throughput multi-image decoder.

    Args:
      budget_mcus: MCUs per device batch (static shape; one compiled program
        per (mode, budget)).  Must be a multiple of ``lane_tile``.
      lane_tile: MCU padding granule of every device batch.
      prepare_threads: host entropy-decode parallelism.
      keep_rgb: retain decoded arrays in results (for benchmarking/tests).
    """

    def __init__(self, budget_mcus: Optional[int] = None,
                 lane_tile: Optional[int] = None,
                 prepare_threads: Optional[int] = None,
                 keep_rgb: bool = False,
                 scale: Optional[int] = None,
                 config: Optional["EngineConfig"] = None):
        from pim_jpeg_decoder_tpu.utils.config import EngineConfig
        cfg = config or EngineConfig.from_env(
            budget_mcus=budget_mcus, lane_tile=lane_tile,
            prepare_threads=prepare_threads, scale=scale)
        cfg.validate()
        self.config = cfg
        self.budget_mcus = cfg.budget_mcus
        self.lane_tile = cfg.lane_tile
        self.prepare_threads = cfg.prepare_threads
        self.max_images = cfg.max_images_per_batch
        self.max_launch_mcus = cfg.max_launch_mcus
        self.scale = cfg.scale
        self.transport = cfg.transport
        self.wire = cfg.wire
        self.keep_rgb = keep_rgb

        # Shard MCU tiles across all LOCAL devices (the reference's
        # DPU_ALLOCATE_ALL analogue, reference: src/decoder_host.cpp:32);
        # single-device hosts use the plain path.  Local devices only: in a
        # multi-host run images are whole-host-sharded, so each process
        # drives just its own cards (jax.devices() would span processes).
        import jax
        n = cfg.num_devices or len(jax.local_devices())
        self._mesh = None
        self.batch_align = self.lane_tile
        if n > 1:
            from pim_jpeg_decoder_tpu.parallel.mesh import make_mesh
            self._mesh = make_mesh(n)
            # Batches (incl. bucketed partial ones) must split evenly
            # across chips.
            self.batch_align = n * self.lane_tile
            self.budget_mcus = (-(-self.budget_mcus // self.batch_align)
                                * self.batch_align)

    # -- pipeline stages ------------------------------------------------------

    def _prepare(self, name: str, data: bytes, uid: int,
                 timers: StageTimers) -> PreparedImage:
        with timers.stage("prepare"):
            header = scan_jpeg(data)
            # Dedicated/banded-route images (bigger than a packed batch)
            # dominate the prepare pool's wall clock on their own, so fan
            # their restart segments across cores instead of decoding the
            # whole bitstream on one (SURVEY.md section 2 item 4; the
            # native path clamps to the available segments/work, so this
            # is a no-op for non-DRI or small images).  Capped at the
            # core count: fan-out on fewer cores than threads measured
            # ~10% SLOWER (bench_dri_segment_parallel on the 1-core rig).
            threads = 1
            if header.num_mcus > self.budget_mcus:
                threads = min(self.prepare_threads, os.cpu_count() or 1)
            coeffs = entropy_decode(header, threads=threads)
            return PreparedImage(name, header, coeffs, uid=uid)

    def _stage_batch(self, batch: Batch, timers: StageTimers) -> Batch:
        """Start the H2D transfer asynchronously (producer side), so it
        overlaps with the consumer's device execution of earlier batches —
        the H2D half of the reference's copy/exec overlap
        (reference: src/decoder_host.cpp:276-292)."""
        import jax
        if self.wire == "auto":
            # int8 coefficient wire when the whole batch fits: half the
            # H2D bytes, widened on device (see batching.compact_wire).
            batch.coeffs = compact_wire(batch.coeffs)
        if self._mesh is not None:
            n = self._mesh.devices.size
            if batch.coeffs.shape[0] % (n * self.lane_tile) == 0:
                # Producer-side mesh placement: the multi-chip H2D of
                # batch N+1 overlaps the consumer's dispatch of batch N
                # (decode_mcus_sharded passes placed inputs through).
                from pim_jpeg_decoder_tpu.parallel.sharding import (
                    place_for_mesh,
                )
                with timers.stage("h2d"):
                    batch.coeffs, batch.qidx, batch.qpool = place_for_mesh(
                        batch.coeffs, batch.qidx, batch.qpool, self._mesh)
            return batch  # non-divisible batches dispatch single-device
        with timers.stage("h2d"):
            batch.coeffs = jax.device_put(batch.coeffs)
            batch.qidx = jax.device_put(batch.qidx)
            batch.qpool = jax.device_put(batch.qpool)
        return batch

    def _dedicated_budget(self, num_mcus: int) -> int:
        """Launch size for a dedicated (single-image/band) router: the
        smallest covering bucket, capped at max_launch_mcus (the documented
        device-memory bound) and aligned to lane_tile."""
        lt = self.lane_tile
        if num_mcus <= S.MCU_BUCKETS[-1]:
            budget = min(S.bucket_mcus(num_mcus),
                         max(self.max_launch_mcus, lt))
            budget = max(budget, num_mcus)
        else:
            budget = num_mcus
        return -(-budget // lt) * lt

    def _split_bands(self, prepared: PreparedImage):
        """MCU-aligned tiles for an over-max_launch_mcus image (generator).

        Tiles are whole MCU sub-grids: full-width row bands when a row fits
        the launch cap, 2-D tiles otherwise (ultra-wide images), so no
        single launch exceeds max_launch_mcus.  Each tile decodes as its
        own bucket-aligned launch; the decoded rasters paste into one
        shared accumulator (the consumer thread is the only writer, so no
        locking).  Yielding tiles one at a time keeps peak host memory at
        a few tiles (queue backpressure), not a full second copy."""
        header = prepared.header
        mode = S.mode_for(header.mode_key)
        gw, gh = header.mcu_cols, header.mcu_rows
        cols_per = min(gw, self.max_launch_mcus)
        rows_per = max(1, self.max_launch_mcus // cols_per)
        px_h, px_w = 8 * mode.v, 8 * mode.h
        out_h = -(-header.height // self.scale)
        out_w = -(-header.width // self.scale)
        n_tiles = (-(-gh // rows_per)) * (-(-gw // cols_per))
        acc = _BandAccumulator(
            prepared.name, prepared.uid, header,
            np.empty((out_h, out_w, 3), np.uint8),
            remaining=n_tiles)
        grid = prepared.coeffs[: gh * gw].reshape(gh, gw, mode.g, 64)
        for r0 in range(0, gh, rows_per):
            rows = min(rows_per, gh - r0)
            for c0 in range(0, gw, cols_per):
                cols = min(cols_per, gw - c0)
                tile_header = dataclasses.replace(
                    header,
                    height=min(rows * px_h, header.height - r0 * px_h),
                    width=min(cols * px_w, header.width - c0 * px_w))
                tile_coeffs = np.ascontiguousarray(
                    grid[r0:r0 + rows, c0:c0 + cols]).reshape(-1, mode.g, 64)
                tile = PreparedImage(
                    prepared.name, tile_header, tile_coeffs,
                    uid=prepared.uid,
                    band_target=(acc, r0 * px_h // self.scale,
                                 c0 * px_w // self.scale))
                router = ModeRouter(self._dedicated_budget(
                    tile_header.num_mcus), max_images=1,
                    lane_tile=self.batch_align)
                router.add(tile)
                yield from router.flush_all()

    def _use_ycbcr(self, mode: S.ModeSpec) -> bool:
        """YCbCr wire transport whenever it reduces D2H bytes (all modes
        except 4:4:4, where the plane counts are equal)."""
        if self.scale != 1:
            # Scaled decode emits reduced RGB directly (already fewer wire
            # bytes than full-res ycbcr); transport='ycbcr' + scale!=1 is
            # rejected by EngineConfig.validate().
            return False
        if self.transport == "rgb":
            return False
        if self.transport == "ycbcr":
            return True
        return mode.ycbcr_saves_bytes

    def _launch_key(self, batch: Batch, sharded: bool) -> tuple:
        """Launch geometry, one key per compiled device program: PER-DEVICE
        MCU count (a mesh launch runs M/n_devices per device) + wire dtype
        (the int8 wire compiles a distinct, cheaper-input program) +
        quant-pool depth Q (packed Q=max_images and dedicated/banded Q=1
        batches are distinct compiled programs)."""
        m = int(batch.coeffs.shape[0])
        if sharded:
            m //= self._mesh.devices.size
        wire = "i8" if batch.coeffs.dtype == np.int8 else "i16"
        return ((batch.mode.h, batch.mode.v, batch.mode.ncomp), m,
                self.lane_tile, batch.transport, self.scale, wire,
                int(batch.qpool.shape[0]))

    def _dispatch_batch(self, batch: Batch, timers: StageTimers):
        """Launch the device decode asynchronously (JAX dispatch returns
        immediately; the device pipeline below overlaps execution + D2H of
        batch N with dispatch of batch N+1).

        Returns ``(device_output, launch_key)`` — the key is recorded by
        the caller only AFTER a successful dispatch, so failed launches
        never inflate the launch counts.
        """
        ycbcr = self._use_ycbcr(batch.mode)
        batch.transport = "ycbcr" if ycbcr else "rgb"
        with timers.stage("kernel"):
            sharded = self._mesh is not None and (
                batch.coeffs.shape[0]
                % (self._mesh.devices.size * self.lane_tile) == 0)
            key = self._launch_key(batch, sharded)
            if sharded:
                from pim_jpeg_decoder_tpu.parallel.sharding import (
                    decode_mcus_sharded,
                )
                return decode_mcus_sharded(
                    batch.coeffs, batch.qidx, batch.qpool, batch.mode,
                    mesh=self._mesh, lane_tile=self.lane_tile,
                    raw=not ycbcr, ycbcr=ycbcr, scale=self.scale), key
            return decode_mcus(batch.coeffs, batch.qidx, batch.qpool,
                               batch.mode, lane_tile=self.lane_tile,
                               raw=not ycbcr, ycbcr=ycbcr,
                               scale=self.scale), key

    def _finish_batch(self, batch: Batch, raw_rgb_dev, timers: StageTimers,
                      write: bool, results: Dict[int, FileResult],
                      finish_pool=None) -> None:
        ycbcr = batch.transport == "ycbcr"
        with timers.stage("d2h"):
            # [g, 64, budget] YCbCr planes or [3, luma_slots, 64, budget] RGB
            raw = np.asarray(raw_rgb_dev)

        def finish_safe(img, off) -> None:
            # Per-image isolation: an assembly/write failure must not
            # poison the other images of the batch (validate-and-skip,
            # reference: src/decoder_host.cpp:120-123).
            try:
                self._finish_image(img, off, raw, ycbcr, write, results)
            except Exception as e:
                logger.error("finishing %s failed: %s", img.name, e)
                if img.band_target is not None:
                    img.band_target[0].failed = True
                results[img.uid] = FileResult(
                    img.name, False, error=f"output failed: {e}")

        with timers.stage("write"):
            # Fan independent images across the finish pool (the C++
            # finishers release the GIL); banded images run here on the
            # consumer thread — the accumulator bookkeeping is not
            # thread-safe, and band tiles must land in batch order.
            pooled = []
            if finish_pool is not None and len(batch.images) > 1:
                # Duplicate input names share one BMP output path; a
                # concurrent write would interleave — keep duplicates
                # (and banded images) on the consumer thread.
                names = [img.name for img, _ in batch.images]
                dup = {nm for nm in names if names.count(nm) > 1} \
                    if write else set()
                pooled = [(img, off) for img, off in batch.images
                          if img.band_target is None
                          and img.name not in dup]
            if len(pooled) > 1:
                in_pool = {id(img) for img, _ in pooled}
                futures = [finish_pool.submit(finish_safe, img, off)
                           for img, off in pooled]
                for img, off in batch.images:
                    if id(img) not in in_pool:
                        finish_safe(img, off)
                for fut in futures:
                    fut.result()  # finish_safe never raises
            else:
                for img, off in batch.images:
                    finish_safe(img, off)

    def _finish_image(self, img, off, raw, ycbcr: bool, write: bool,
                      results: Dict[int, FileResult]) -> None:
        if (ycbcr and write and not self.keep_rgb
                and img.band_target is None):
            # One-pass fused finish: wire planes -> padded BGR BMP rows
            # (upsample + color + serialize in a single native sweep, no
            # intermediate RGB raster).  Byte-identical to the two-pass
            # route below; band tiles and keep_rgb callers need the
            # raster, so they take that route.
            from pim_jpeg_decoder_tpu.native import native_available
            if native_available():
                from pim_jpeg_decoder_tpu.io.bmp import write_bmp_ycbcr
                header = img.header
                mode = S.mode_for(header.mode_key)
                res = FileResult(
                    img.name, True,
                    megapixels=header.width * header.height / 1e6)
                res.out_path = output_path(img.name)
                write_bmp_ycbcr(res.out_path, raw, off, mode.v, mode.h,
                                mode.ncomp, header.mcu_rows,
                                header.mcu_cols, header.height,
                                header.width)
                results[img.uid] = res
                return
        if ycbcr:
            rgb = assemble_raster_ycbcr(img.header, raw, mcu_off=off)
        elif self.scale != 1:
            # Pass the FULL batch buffer + offset: a lane-padded slice is
            # never C-contiguous and would silently bypass the C++ fast
            # path (and hold the GIL through the NumPy fallback).
            rgb = assemble_raster_raw_scaled(img.header, raw, self.scale,
                                             mcu_off=off)
        else:
            rgb = assemble_raster_raw(img.header, raw, mcu_off=off)
        if img.band_target is not None:
            acc, y0, x0 = img.band_target
            acc.raster[y0:y0 + rgb.shape[0], x0:x0 + rgb.shape[1]] = rgb
            acc.remaining -= 1
            if acc.remaining > 0 or acc.failed:
                return
            img_name, header, rgb = acc.name, acc.header, acc.raster
            uid = acc.uid
        else:
            img_name, header, uid = img.name, img.header, img.uid
        res = FileResult(
            img_name, True,
            megapixels=header.width * header.height / 1e6)
        if write:
            res.out_path = output_path(img_name)
            write_bmp(res.out_path, rgb)
        if self.keep_rgb:
            res.rgb = rgb
        results[uid] = res

    # -- public API -----------------------------------------------------------

    def decode_named_blobs(self, items: Sequence[Tuple[str, bytes]],
                           write: bool = False) -> EngineReport:
        """Decode (name, bytes) pairs through the full pipeline.

        Set PIM_JPEG_TPU_PROFILE=<dir> to capture a ``jax.profiler`` trace
        of the run (device-side per-kernel timing; the reference's DPU cycle
        counters analogue, reference: src/decoder_dpu.c:52-55).
        """
        import contextlib
        import os as _os

        trace_dir = _os.environ.get("PIM_JPEG_TPU_PROFILE")
        if trace_dir:
            import jax
            trace_ctx = jax.profiler.trace(trace_dir)
        else:
            trace_ctx = contextlib.nullcontext()
        with trace_ctx:
            return self._decode_named_blobs(items, write)

    def _decode_named_blobs(self, items: Sequence[Tuple[str, bytes]],
                            write: bool) -> EngineReport:
        timers = StageTimers()
        results: Dict[int, FileResult] = {}
        launch_stats: Dict[tuple, int] = {}
        dispatch_times: Dict[tuple, list] = {}
        batch_q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=4)
        router = ModeRouter(self.budget_mcus, max_images=self.max_images,
                            lane_tile=self.batch_align)

        def consumer() -> None:
            import collections
            pending = collections.deque()  # depth-2 device pipeline
            # Per-image finishing (raster assembly + color + BMP) is C++
            # with the GIL released, so a multi-image batch fans out
            # across threads — on a many-core host the consumer thread
            # would otherwise serialize ~3 ms/MP of finish work behind
            # every dispatch.  Banded images stay on the consumer thread
            # (the band accumulator's bookkeeping is not thread-safe).
            finish_pool = (ThreadPoolExecutor(self.prepare_threads,
                                              thread_name_prefix="pjt-fin")
                           if self.prepare_threads > 1 else None)

            def drain_one() -> None:
                batch, dev = pending.popleft()
                try:
                    self._finish_batch(batch, dev, timers, write, results,
                                       finish_pool)
                except Exception as e:  # record, don't kill the pipeline
                    logger.error("device decode failed: %s", e)
                    for img, _ in batch.images:
                        if img.band_target is not None:
                            img.band_target[0].failed = True
                        results[img.uid] = FileResult(
                            img.name, False, error=f"device decode failed: {e}")

            while True:
                with timers.stage("queue"):
                    batch = batch_q.get()
                if batch is None:
                    break
                try:
                    t_disp = time.monotonic()
                    dev, launch_key = self._dispatch_batch(batch, timers)
                    # Consumer thread is the only writer; count only
                    # launches that actually dispatched.
                    launch_stats[launch_key] = (
                        launch_stats.get(launch_key, 0) + 1)
                    dispatch_times.setdefault(launch_key, []).append(
                        time.monotonic() - t_disp)
                    # Start the D2H transfer immediately so it overlaps the
                    # host-side assembly/BMP write of the previous batch
                    # (the D2H half of the reference's copy/exec overlap,
                    # reference: src/decoder_host.cpp:292-330).
                    try:
                        dev.copy_to_host_async()
                    except (AttributeError, RuntimeError):
                        pass  # non-addressable/sharded or older jax
                    pending.append((batch, dev))
                except Exception as e:
                    for img, _ in batch.images:
                        if img.band_target is not None:
                            img.band_target[0].failed = True
                        results[img.uid] = FileResult(
                            img.name, False, error=f"device decode failed: {e}")
                if len(pending) >= 2:
                    drain_one()
            while pending:
                drain_one()
            if finish_pool is not None:
                finish_pool.shutdown(wait=True)

        consumer_thread = threading.Thread(target=consumer, daemon=True)
        consumer_thread.start()

        def stage_safe(batches) -> None:
            """Stage+enqueue; staging errors (host/device OOM etc.) are
            per-file failures for the failing batch's OWN images, not run
            killers.  (A flushed batch holds EARLIER images than the one
            whose add() triggered the flush, so attribution must come from
            the batch, not the caller.)"""
            for b in batches:
                try:
                    batch_q.put(self._stage_batch(b, timers))
                except Exception as e:
                    for img, _ in b.images:
                        logger.warning("staging %s failed: %s",
                                       img.name, e)
                        if img.band_target is not None:
                            img.band_target[0].failed = True
                        results[img.uid] = FileResult(
                            img.name, False,
                            error=f"staging failed: {e}")

        with ThreadPoolExecutor(self.prepare_threads) as pool:
            # Bounded submission window: a completed-but-unconsumed
            # prepare future holds a full coefficient array, so submitting
            # every item up front would let the pool run unboundedly ahead
            # of the device consumer on large corpora (host OOM).  The
            # window keeps the pool saturated while capping held results;
            # downstream, the bounded batch queue throttles this loop.
            from collections import deque
            window = max(2 * self.prepare_threads, 4)
            item_iter = iter(enumerate(items))
            inflight = deque()

            def submit_next() -> None:
                for i, (name, data) in item_iter:
                    inflight.append((i, name, pool.submit(
                        self._prepare, name, data, i, timers)))
                    return

            for _ in range(window):
                submit_next()
            while inflight:
                uid, name, fut = inflight.popleft()
                submit_next()
                try:
                    prepared = fut.result()
                except Exception as e:
                    logger.warning("skipping %s: %s", name, e)
                    results[uid] = FileResult(name, False, error=str(e))
                    continue
                # Beyond the largest single launch: decode in
                # MCU-row-aligned chunks (the reference rejects these,
                # "Too high resolution", reference: src/decoder_host.cpp:146).
                if prepared.header.num_mcus > self.max_launch_mcus:
                    stage_safe(self._split_bands(prepared))
                    continue
                # Oversized image: dedicated launch, bucket-aligned so the
                # set of compiled kernel shapes stays bounded.
                if prepared.header.num_mcus > self.budget_mcus:
                    big = ModeRouter(
                        self._dedicated_budget(prepared.header.num_mcus),
                        max_images=1, lane_tile=self.batch_align)
                    big.add(prepared)
                    stage_safe(big.flush_all())
                    continue
                stage_safe(router.add(prepared))
        try:
            stage_safe(router.flush_all())
        finally:
            batch_q.put(None)
            consumer_thread.join()

        ordered = [results.get(i, FileResult(name, False, error="missing"))
                   for i, (name, _) in enumerate(items)]
        return EngineReport(ordered, timers, launch_stats,
                            dispatch_times)

    def decode_paths(self, paths: Sequence[str], write: bool = True,
                     sort: bool = True) -> EngineReport:
        """Decode files, writing a BMP next to each input by default.

        Unreadable files are recorded as failures and skipped, like every
        other per-file error (reference: src/decoder_host.cpp:120-123).
        """
        items = []
        io_failures = []
        for p in paths:
            try:
                with open(p, "rb") as f:
                    items.append((p, f.read()))
            except OSError as e:
                logger.warning("cannot read %s: %s", p, e)
                io_failures.append(FileResult(p, False, error=str(e)))
        if sort:
            # Same policy as batching.sort_by_size (the path-level API),
            # applied to already-read blobs: blob length == file size.
            by_size = {p: len(d) for p, d in items}
            items.sort(key=lambda kv: (by_size[kv[0]], kv[0]))
        report = self.decode_named_blobs(items, write=write)
        report.results.extend(io_failures)
        return report
