"""Device-resident batch decode: JPEG bytes -> training batch, no host RGB.

The accelerator deployment story the reference cannot have: when decode
feeds an ML input pipeline (the ImageNet use-case of BASELINE.json), the
decoded pixels should never leave the device.  This module decodes a batch of
same-sized JPEGs into a single ``[B, H, W, 3]`` uint8 device array — host
work is only the marker scan + entropy decode (coefficients H2D are ~5-10x
smaller than RGB), and raster assembly happens as XLA reshapes on device
instead of NumPy on host.

Same-size batches are the natural unit for dataset pipelines (size
bucketing happens upstream); mixed-size corpora use
:class:`pim_jpeg_decoder_tpu.runtime.engine.DecodeEngine` instead.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from pim_jpeg_decoder_tpu.codec.header import JpegError, JpegHeader
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.models.pipeline import build_qpool, entropy_decode
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import LANE_TILE, decode_mcus_impl


def _norm_static(dtype, mean, std):
    """Validate and canonicalize the fused-normalization options into a
    hashable static spec ``(dtype, mean3, inv_std3)`` (None = raw uint8).

    ``mean``/``std`` are per-channel (scalar or length-3) training-set
    statistics in 0..255 pixel units; they require a floating ``dtype``.
    The spec is a static jit argument, so each distinct (dtype, mean, std)
    triple compiles once — normalization constants are per-dataset
    constants, not per-batch data.
    """
    if dtype is None:
        if mean is not None or std is not None:
            raise ValueError("mean/std require dtype (a floating type)")
        return None
    dtype = jnp.dtype(dtype)
    if not jnp.issubdtype(dtype, jnp.floating):
        raise ValueError(f"dtype must be floating, got {dtype}")

    def chan3(v, name):
        if v is None:
            return None
        arr = np.asarray(v, np.float32).reshape(-1)
        if arr.size == 1:
            arr = np.repeat(arr, 3)
        if arr.size != 3:
            raise ValueError(f"{name} must be scalar or length-3, got "
                             f"{np.asarray(v).shape}")
        return tuple(float(x) for x in arr)

    mean3 = chan3(mean, "mean")
    std3 = chan3(std, "std")
    if std3 is not None:
        if any(s == 0.0 for s in std3):
            raise ValueError("std must be nonzero")
        std3 = tuple(1.0 / s for s in std3)  # multiply beats divide
    return (dtype, mean3, std3)


def _apply_norm(img, norm):
    """Fused uint8 -> normalized-float epilogue: compute in float32
    (exact for 0..255 inputs), cast to the requested dtype last.  Runs
    inside the decode jit, so XLA fuses it into the raster relayout —
    no extra HBM pass vs normalizing in user code outside the jit."""
    if norm is None:
        return img
    dtype, mean3, inv_std3 = norm
    x = img.astype(jnp.float32)
    if mean3 is not None:
        x = x - jnp.asarray(mean3, jnp.float32)
    if inv_std3 is not None:
        x = x * jnp.asarray(inv_std3, jnp.float32)
    return x.astype(dtype)


def _raster_relayout(raw, mode: S.ModeSpec, scale: int, batch: int,
                     gh: int, gw: int):
    """[3, V*H, nn, B*M] kernel-native -> [B, gh*V*n, gw*H*n, 3] raster
    (one fused relayout on device instead of two).  Kernel-native slot
    pixel order is COLUMN-major: reshape as (px, py).  Shared by the
    full-batch and crop-batch decode programs so the layout contract
    lives in exactly one place."""
    v, h = mode.v, mode.h
    n = 8 // scale
    img = raw[..., : batch * gh * gw]
    img = img.reshape(3, v, h, n, n, batch, gh, gw)
    img = img.transpose(5, 6, 1, 4, 7, 2, 3, 0)
    return img.reshape(batch, gh * v * n, gw * h * n, 3)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "batch", "gh", "gw", "height", "width",
                     "scale", "norm"),
)
def _decode_batch_jit(coeffs, qidx, qpool, *, mode: S.ModeSpec, batch: int,
                      gh: int, gw: int, height: int, width: int,
                      scale: int = 1, norm=None):
    raw = decode_mcus_impl(coeffs, qidx, qpool, mode=mode, raw=True,
                           scale=scale)
    img = _raster_relayout(raw, mode, scale, batch, gh, gw)
    return _apply_norm(img[:, :height, :width, :], norm)


def _mesh_align(mesh, lane_tile: int) -> int:
    """Transport-row alignment for a batch: each card's shard must be a
    whole number of lane tiles (the MCU padding granule)."""
    if mesh is None:
        return lane_tile
    return mesh.devices.size * lane_tile


@functools.lru_cache(maxsize=None)
def _sharded_batch_fn(mesh, mode: S.ModeSpec, batch: int, gh: int, gw: int,
                      height: int, width: int, scale: int, norm):
    """Compiled multi-card batch-decode program: the device decode runs
    under shard_map over the MCU axis (each card decodes its MCU slice,
    no collectives — MCUs are independent), then the raster relayout +
    normalization run under the same jit, where XLA inserts the minimal
    resharding; the output is constrained to batch-axis sharding when the
    batch divides the mesh (the data-parallel layout a training step
    wants).  Reference analog: inter-DPU data parallelism
    (src/decoder_host.cpp:125-128), here for the ML input path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pim_jpeg_decoder_tpu.parallel.mesh import MCU_AXIS

    impl = functools.partial(decode_mcus_impl, mode=mode, raw=True,
                             scale=scale)
    shmapped = jax.shard_map(
        impl, mesh=mesh,
        in_specs=(P(MCU_AXIS), P(MCU_AXIS), P()),
        out_specs=P(None, None, None, MCU_AXIS),
        # Purely elementwise over the MCU axis (see parallel/sharding.py).
        check_vma=False,
    )

    def fn(coeffs, qidx, qpool):
        raw = shmapped(coeffs, qidx, qpool)
        img = _raster_relayout(raw, mode, scale, batch, gh, gw)
        out = _apply_norm(img[:, :height, :width, :], norm)
        if batch % mesh.devices.size == 0:
            out = jax.lax.with_sharding_constraint(
                out, NamedSharding(mesh, P(MCU_AXIS)))
        return out

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _sharded_crops_fn(mesh, mode: S.ModeSpec, batch: int, gh: int, gw: int,
                      crop_h: int, crop_w: int, scale: int, norm):
    """Multi-card variant of ``_decode_batch_crops_jit`` (see
    :func:`_sharded_batch_fn` for the sharding structure)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pim_jpeg_decoder_tpu.parallel.mesh import MCU_AXIS

    impl = functools.partial(decode_mcus_impl, mode=mode, raw=True,
                             scale=scale)
    shmapped = jax.shard_map(
        impl, mesh=mesh,
        in_specs=(P(MCU_AXIS), P(MCU_AXIS), P()),
        out_specs=P(None, None, None, MCU_AXIS),
        check_vma=False,
    )

    def fn(coeffs, qidx, qpool, oys, oxs):
        raw = shmapped(coeffs, qidx, qpool)
        img = _raster_relayout(raw, mode, scale, batch, gh, gw)
        crops = jax.vmap(
            lambda im, oy, ox: jax.lax.dynamic_slice(
                im, (oy, ox, jnp.int32(0)),
                (crop_h // scale, crop_w // scale, 3)))(img, oys, oxs)
        out = _apply_norm(crops, norm)
        if batch % mesh.devices.size == 0:
            out = jax.lax.with_sharding_constraint(
                out, NamedSharding(mesh, P(MCU_AXIS)))
        return out

    return jax.jit(fn)


def _scan_same_size(blobs: Sequence[bytes], caller: str):
    """Parse headers and enforce the identical-(size, mode) contract."""
    headers = [scan_jpeg(b) for b in blobs]
    h0 = headers[0]
    for h in headers[1:]:
        if (h.width, h.height, h.mode_key) != (h0.width, h0.height,
                                               h0.mode_key):
            raise JpegError(
                f"{caller} requires identical dimensions and sampling: "
                f"{(h.width, h.height, h.mode_key)} != "
                f"{(h0.width, h0.height, h0.mode_key)}")
    return headers, h0, S.mode_for(h0.mode_key)


def _scan_same_mode(blobs: Sequence[bytes], caller: str):
    """Parse headers and enforce an identical sampling MODE (dimensions
    free — the mixed-size crop path's contract; the fused kernel is
    compiled per sampling mode)."""
    headers = [scan_jpeg(b) for b in blobs]
    h0 = headers[0]
    for h in headers[1:]:
        if h.mode_key != h0.mode_key:
            raise JpegError(
                f"{caller} requires identical sampling modes: "
                f"{h.mode_key} != {h0.mode_key}")
    return headers, h0, S.mode_for(h0.mode_key)


_PREP_POOLS: dict = {}
_PREP_LOCK = threading.Lock()


def _prep_pool(workers: int):
    """Persistent entropy-decode executors, keyed by worker count: the
    streaming APIs hit this once per yielded batch, so pool startup must
    not be paid per call.  Shared across concurrent host stages — the
    worker count is a host-CPU budget, not a per-batch one."""
    pool = _PREP_POOLS.get(workers)
    if pool is None:
        with _PREP_LOCK:
            pool = _PREP_POOLS.get(workers)
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor
                pool = ThreadPoolExecutor(workers,
                                          thread_name_prefix="pjt-prep")
                _PREP_POOLS[workers] = pool
    return pool


def _entropy_decode_pool(headers, prepare_threads: int, outs=None):
    """Entropy decode in parallel (the C++ decoder releases the GIL).
    ``outs`` (optional) are per-header caller-zeroed destination arrays
    (transport-buffer slices), passed through to ``entropy_decode``.
    The pool is keyed by ``prepare_threads`` alone (ragged batch sizes
    must not mint extra pools — the worker count is the host-CPU budget,
    and a small batch simply leaves workers idle)."""
    if outs is None:
        outs = [None] * len(headers)
    n = len(headers)
    if prepare_threads <= 1:
        return [entropy_decode(h, o) for h, o in zip(headers, outs)]
    # Idle-worker reuse: a batch with fewer images than workers leaves
    # cores idle, so give each image the spare share for restart-segment
    # fan-out (no-op for non-DRI/small images — the native path clamps;
    # capped at the core count, where fan-out measured ~10% slower).
    import os as _os
    seg_threads = max(1, min(prepare_threads, _os.cpu_count() or 1) // n)
    if n == 1:
        return [entropy_decode(headers[0], outs[0], threads=seg_threads)]
    return list(_prep_pool(max(1, prepare_threads)).map(
        lambda h, o: entropy_decode(h, o, threads=seg_threads),
        headers, outs))


def _check_wire(wire: str) -> None:
    if wire not in ("auto", "i16"):
        raise ValueError(f"wire must be auto/i16, got {wire!r}")


def _maybe_compact(coeffs, wire: str):
    if wire == "auto":
        from pim_jpeg_decoder_tpu.runtime.batching import compact_wire
        return compact_wire(coeffs)
    return coeffs


def _tstage(timers, name: str):
    """`timers.stage(name)` or a no-op when no timers were passed."""
    return timers.stage(name) if timers is not None else contextlib.nullcontext()


def _host_stage(blobs: Sequence[bytes], lane_tile: int,
                prepare_threads: int, wire: str, caller: str,
                align: Optional[int] = None, timers=None):
    """Host half of a same-size batch decode: scan + entropy decode +
    transport staging + wire compaction.  Pure host work (no JAX calls),
    so it runs safely on a prefetch worker thread.  ``align`` (default
    ``lane_tile``) pads the transport to whole per-chip lane tiles for a
    mesh dispatch.  ``timers`` (optional StageTimers) accumulates
    per-stage seconds using the engine's taxonomy (scan / entropy /
    stage)."""
    with _tstage(timers, "scan"):
        headers, h0, mode = _scan_same_size(blobs, caller)
    batch = len(blobs)
    per_img = h0.num_mcus
    align = align or lane_tile
    m_pad = -(-(batch * per_img) // align) * align

    with _tstage(timers, "stage"):
        coeffs = np.zeros((m_pad, mode.g, 64), np.int16)
        qidx = np.zeros(m_pad, np.int32)
    # Decode straight into the transport buffer's per-image slices (the
    # native decoder takes a caller-zeroed destination), skipping one
    # full-batch copy.
    with _tstage(timers, "entropy"):
        _entropy_decode_pool(
            headers, prepare_threads,
            outs=[coeffs[i * per_img:(i + 1) * per_img]
                  for i in range(batch)])
    with _tstage(timers, "stage"):
        for i in range(batch):
            qidx[i * per_img:(i + 1) * per_img] = i
        qpool = build_qpool(headers, mode)
        coeffs = _maybe_compact(coeffs, wire)
    return headers, h0, mode, coeffs, qidx, qpool, batch


def _dispatch_staged(staged, lane_tile: int, scale: int, norm=None,
                     mesh=None, timers=None):
    """Device half: H2D + fused kernel + raster relayout (async).
    With ``mesh``, inputs are placed sharded over the MCU axis and the
    multi-chip program runs (see :func:`_sharded_batch_fn`).  With
    ``timers``, the h2d and device stages BLOCK at their boundaries so the
    split is attributable (a profiling run — the un-instrumented path
    stays fully async)."""
    headers, h0, mode, coeffs, qidx, qpool, batch = staged
    height, width = -(-h0.height // scale), -(-h0.width // scale)
    if mesh is not None:
        from pim_jpeg_decoder_tpu.parallel.sharding import place_for_mesh
        with _tstage(timers, "h2d"):
            coeffs, qidx, qpool = place_for_mesh(coeffs, qidx, qpool, mesh)
            if timers is not None:
                jax.block_until_ready((coeffs, qidx, qpool))
        fn = _sharded_batch_fn(mesh, mode, batch, h0.mcu_rows, h0.mcu_cols,
                               height, width, scale, norm)
        with _tstage(timers, "device"):
            out = fn(coeffs, qidx, qpool)
            if timers is not None:
                jax.block_until_ready(out)
        return out, headers
    with _tstage(timers, "h2d"):
        coeffs = jnp.asarray(coeffs)
        qidx = jnp.asarray(qidx)
        qpool = jnp.asarray(qpool, jnp.float32)
        if timers is not None:
            jax.block_until_ready((coeffs, qidx, qpool))
    with _tstage(timers, "device"):
        out = _decode_batch_jit(
            coeffs, qidx, qpool,
            mode=mode, batch=batch, gh=h0.mcu_rows, gw=h0.mcu_cols,
            height=height, width=width,
            scale=scale, norm=norm)
        if timers is not None:
            jax.block_until_ready(out)
    return out, headers


def decode_same_size_batch(
    blobs: Sequence[bytes],
    lane_tile: int = LANE_TILE,
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    dtype=None,
    mean=None,
    std=None,
    mesh=None,
    timers=None,
) -> Tuple[jax.Array, List[JpegHeader]]:
    """Decode same-sized JPEGs into one device-resident ``[B, H, W, 3]``.

    ``timers`` (optional ``utils.profiling.StageTimers``) accumulates the
    per-stage split (scan / entropy / stage / h2d / device) for profiling
    runs; the h2d and device stages then block at their boundaries so the
    attribution is real — leave it None on the throughput path.

    All images must share dimensions and sampling mode.  Returns the device
    array (uint8 by default, still on chip — feed it straight into
    augmentation or a model) and the parsed headers.  ``scale`` in
    {1, 2, 4, 8} decodes at reduced resolution (H and W become
    ceil(dim/scale)) via the reduced IDCT — ~scale^2 less device work for
    pipelines that downsize anyway.  ``wire="auto"`` ships coefficients as
    int8 when the whole batch fits (half the H2D bytes; widened exactly on
    device — see runtime.batching.compact_wire); "i16" disables the
    compaction.

    ``dtype`` (a floating type, e.g. ``jnp.bfloat16``) with optional
    per-channel ``mean``/``std`` (0..255 pixel units) fuses the standard
    training input transform ``(pixels - mean) / std`` into the decode
    program: computed in float32, cast to ``dtype`` last, and fused by XLA
    into the raster relayout, so the normalized batch costs no extra HBM
    pass (normalizing in user code outside the jit reads and writes the
    batch once more).  Each distinct (dtype, mean, std) compiles once.

    ``mesh`` (opt-in, a ``jax.sharding.Mesh`` from
    :func:`pim_jpeg_decoder_tpu.parallel.mesh.make_mesh`) shards the
    decode across local chips: MCU tiles split over the mesh for the
    kernel, and the returned batch is sharded over the image axis when
    the batch divides the mesh — equal to the single-device result
    (tested on the virtual 8-device mesh).

    For back-to-back batches use :func:`iter_decode_batches`, which
    overlaps the host half of batch N+1 with device decode of batch N.
    """
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)
    if not blobs:
        raise ValueError("empty batch")
    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache
    ensure_compilation_cache()
    staged = _host_stage(blobs, lane_tile, prepare_threads, wire,
                         "decode_same_size_batch",
                         align=_mesh_align(mesh, lane_tile), timers=timers)
    return _dispatch_staged(staged, lane_tile, scale, norm, mesh,
                            timers=timers)


def _prefetched(stage_thunks, prefetch: int):
    """Shared prefetch scaffold for the streaming APIs: run host-stage
    thunks on up to ``prefetch`` worker threads, yielding staged results
    in input order.  The thunk iterator is advanced lazily on the
    consuming thread (so its validation errors propagate to the caller),
    and the pool drains fully on early generator close."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache
    ensure_compilation_cache()

    it = iter(stage_thunks)
    with ThreadPoolExecutor(prefetch,
                            thread_name_prefix="pjt-prefetch") as pool:
        pending = deque()

        def submit_next() -> bool:
            try:
                thunk = next(it)
            except StopIteration:
                return False
            pending.append(pool.submit(thunk))
            return True

        for _ in range(prefetch):
            if not submit_next():
                break
        while pending:
            staged = pending.popleft().result()
            submit_next()
            yield staged


def iter_decode_batches(
    blob_batches,
    lane_tile: int = LANE_TILE,
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    prefetch: int = 2,
    dtype=None,
    mean=None,
    std=None,
    mesh=None,
    timers=None,
):
    """Streaming same-size batch decode with host/device overlap.

    Yields ``(device_batch, headers)`` per input batch — exactly what
    :func:`decode_same_size_batch` returns for that batch (a CPU test
    asserts equality) — while the host half (marker scan + C++ entropy
    decode + staging) of up to ``prefetch`` upcoming batches runs on
    worker threads.  Because device dispatch is asynchronous, device
    decode of batch N overlaps entropy decode of batches N+1..N+prefetch:
    the same producer/consumer overlap the BMP engine implements
    (runtime/engine.py) and the reference gets from its two host threads
    (reference: src/decoder_host.cpp:35-38,364-365), here for the
    deployment-recommended ML input path.

    ``blob_batches`` is any iterable of same-size blob sequences (batches
    may differ in size/mode from each other; each batch must be internally
    uniform).  Worker threads run only host code; all JAX dispatch happens
    on the consuming thread.  ``dtype``/``mean``/``std`` fuse normalization
    into the decode program (see :func:`decode_same_size_batch`);
    ``mesh`` shards each batch across local chips (see there).
    """
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)

    def stage_thunks():
        for batch in blob_batches:
            blobs = list(batch)
            if not blobs:
                raise ValueError("empty batch")
            yield functools.partial(
                _host_stage, blobs, lane_tile, prepare_threads, wire,
                "iter_decode_batches", _mesh_align(mesh, lane_tile),
                timers)

    for staged in _prefetched(stage_thunks(), prefetch):
        yield _dispatch_staged(staged, lane_tile, scale, norm, mesh,
                               timers=timers)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "batch", "gh", "gw", "crop_h", "crop_w",
                     "scale", "norm"),
)
def _decode_batch_crops_jit(coeffs, qidx, qpool, oys, oxs, *,
                            mode: S.ModeSpec, batch: int, gh: int, gw: int,
                            crop_h: int, crop_w: int, scale: int = 1,
                            norm=None):
    raw = decode_mcus_impl(coeffs, qidx, qpool, mode=mode, raw=True,
                           scale=scale)
    img = _raster_relayout(raw, mode, scale, batch, gh, gw)
    # Per-image sub-pixel offset into the covering MCU grid (on device);
    # offsets and crop dims arrive pre-divided by scale.
    crops = jax.vmap(
        lambda im, oy, ox: jax.lax.dynamic_slice(
            im, (oy, ox, jnp.int32(0)),
            (crop_h // scale, crop_w // scale, 3)))(img, oys, oxs)
    return _apply_norm(crops, norm)


def decode_same_size_batch_crops(
    blobs: Sequence[bytes],
    boxes: Sequence[Tuple[int, int]],
    crop_hw: Tuple[int, int],
    lane_tile: int = LANE_TILE,
    prepare_threads: int = 4,
    wire: str = "auto",
    scale: int = 1,
    dtype=None,
    mean=None,
    std=None,
    mesh=None,
) -> Tuple[jax.Array, List[JpegHeader]]:
    """Decode one ``crop_h x crop_w`` crop per image -> ``[B, ch, cw, 3]``.

    The ML-input-pipeline random-crop primitive: per-image crop origins
    ``boxes[i] = (y0, x0)`` (top-left, pixel units), one fixed crop size.
    Entropy decode is whole-scan (serial bitstream), but device work and
    the coefficient H2D wire shrink to each crop's covering MCU sub-grid —
    ~(image area / crop area)x less than a full decode for pipelines that
    crop anyway.  Pixels are bit-identical to the same slice of a full
    decode; the per-image pixel offset is applied on device
    (vmapped ``dynamic_slice``), so the batch never leaves the chip.

    ``scale`` in {1, 2, 4, 8} combines the crop with reduced-IDCT scaled
    decode (the RandomResizedCrop pattern: crop then downsize): the output
    is ``[B, crop_h/scale, crop_w/scale, 3]``, pixel-identical to the same
    slice of a full scaled decode.  Crop origins and dims must be
    multiples of ``scale`` (a scaled pixel covers a scale x scale full-res
    block, so other crops have no exact scaled representation).

    All images must share dimensions and sampling mode (as in
    :func:`decode_same_size_batch`); ``dtype``/``mean``/``std`` fuse
    normalization into the decode program, and ``mesh`` shards the batch
    across local chips (see there).
    """
    norm = _norm_static(dtype, mean, std)
    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache
    ensure_compilation_cache()
    staged = _host_stage_crops(blobs, boxes, crop_hw, lane_tile, scale,
                               prepare_threads, wire,
                               "decode_same_size_batch_crops",
                               align=_mesh_align(mesh, lane_tile))
    return _dispatch_staged_crops(staged, lane_tile, scale, norm, mesh)


def _host_stage_crops(blobs, boxes, crop_hw, lane_tile: int, scale: int,
                      prepare_threads: int, wire: str, caller: str,
                      align: Optional[int] = None,
                      same_size: bool = True):
    """Host half of a crop-batch decode (validation + scan + entropy +
    per-crop sub-grid staging + wire compaction).  No JAX calls.

    ``same_size=False`` admits MIXED image dimensions (modes must still
    match — one compiled program per sampling mode): a fixed crop size
    means a fixed covering MCU sub-grid, so differently-sized images
    still pack into ONE static-shape launch; images whose own grid is
    smaller than the covering grid zero-pad their tail (the per-image
    dynamic slice never reaches the padding — the crop box is validated
    in-bounds, so every sliced pixel lies in real rows/cols)."""
    _check_wire(wire)
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    if not blobs:
        raise ValueError("empty batch")
    if len(boxes) != len(blobs):
        raise ValueError(f"{len(boxes)} boxes for {len(blobs)} images")
    crop_h, crop_w = crop_hw
    if crop_h <= 0 or crop_w <= 0:
        raise ValueError(f"invalid crop size {crop_hw}")
    if scale != 1:
        bad = [(y0, x0) for y0, x0 in boxes
               if y0 % scale or x0 % scale]
        if bad or crop_h % scale or crop_w % scale:
            raise ValueError(
                f"crop origins and dims must be multiples of scale="
                f"{scale} (got dims {crop_hw}, offending origins "
                f"{bad[:3]})")
    if same_size:
        headers, h0, mode = _scan_same_size(blobs, caller)
    else:
        headers, h0, mode = _scan_same_mode(blobs, caller)
    for h, (y0, x0) in zip(headers, boxes):
        if not (0 <= y0 and 0 <= x0 and y0 + crop_h <= h.height
                and x0 + crop_w <= h.width):
            raise ValueError(
                f"crop [{y0}:{y0 + crop_h}, {x0}:{x0 + crop_w}] outside "
                f"{h.height}x{h.width}")

    px_h, px_w = mode.mcu_px_h, mode.mcu_px_w
    # Fixed covering sub-grid: +1 MCU of slack absorbs arbitrary sub-MCU
    # alignment; clamping the origin to keep the grid in-bounds keeps the
    # SHAPE static (the pixel offset below compensates).  The clamp uses
    # the LARGEST image grid; smaller images zero-pad (see docstring).
    max_gh = max(h.mcu_rows for h in headers)
    max_gw = max(h.mcu_cols for h in headers)
    gh_c = min(max_gh, -(-crop_h // px_h) + 1)
    gw_c = min(max_gw, -(-crop_w // px_w) + 1)

    batch = len(blobs)
    per_img = gh_c * gw_c
    align = align or lane_tile
    m_pad = -(-(batch * per_img) // align) * align
    coeffs = np.zeros((m_pad, mode.g, 64), np.int16)
    qidx = np.zeros(m_pad, np.int32)
    oys = np.zeros(batch, np.int32)
    oxs = np.zeros(batch, np.int32)

    decoded = _entropy_decode_pool(headers, prepare_threads)
    for i, ((y0, x0), h, c) in enumerate(zip(boxes, headers, decoded)):
        gh, gw = h.mcu_rows, h.mcu_cols
        r0 = max(0, min(y0 // px_h, gh - gh_c))
        c0 = max(0, min(x0 // px_w, gw - gw_c))
        # px_h/px_w are multiples of scale and y0/x0 are validated so, so
        # the residual offsets divide exactly.
        oys[i] = (y0 - r0 * px_h) // scale
        oxs[i] = (x0 - c0 * px_w) // scale
        grid = c[: gh * gw].reshape(gh, gw, mode.g, 64)
        sub = grid[r0:r0 + gh_c, c0:c0 + gw_c]
        dst = coeffs[i * per_img:(i + 1) * per_img].reshape(
            gh_c, gw_c, mode.g, 64)
        dst[: sub.shape[0], : sub.shape[1]] = sub
        qidx[i * per_img:(i + 1) * per_img] = i
    qpool = build_qpool(headers, mode)
    coeffs = _maybe_compact(coeffs, wire)
    return (headers, mode, coeffs, qidx, qpool, oys, oxs, batch, gh_c,
            gw_c, crop_h, crop_w)


def _dispatch_staged_crops(staged, lane_tile: int, scale: int, norm=None,
                           mesh=None):
    (headers, mode, coeffs, qidx, qpool, oys, oxs, batch, gh_c, gw_c,
     crop_h, crop_w) = staged
    if mesh is not None:
        from pim_jpeg_decoder_tpu.parallel.sharding import place_for_mesh
        coeffs, qidx, qpool = place_for_mesh(coeffs, qidx, qpool, mesh)
        fn = _sharded_crops_fn(mesh, mode, batch, gh_c, gw_c, crop_h, crop_w,
                               scale, norm)
        return fn(coeffs, qidx, qpool, jnp.asarray(oys),
                  jnp.asarray(oxs)), headers
    out = _decode_batch_crops_jit(
        jnp.asarray(coeffs), jnp.asarray(qidx),
        jnp.asarray(qpool, jnp.float32),
        jnp.asarray(oys), jnp.asarray(oxs),
        mode=mode, batch=batch, gh=gh_c, gw=gw_c, crop_h=crop_h, crop_w=crop_w,
        scale=scale, norm=norm)
    return out, headers


def decode_batch_crops(
    blobs: Sequence[bytes],
    boxes: Sequence[Tuple[int, int]],
    crop_hw: Tuple[int, int],
    lane_tile: int = LANE_TILE,
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    dtype=None,
    mean=None,
    std=None,
    mesh=None,
) -> Tuple[jax.Array, List[JpegHeader]]:
    """Batched random-crop decode over MIXED-SIZE images (r5).

    The RandomResizedCrop shape for real corpora: images may differ in
    dimensions (sampling mode must match — one compiled program per
    mode); a fixed ``crop_hw`` means a fixed covering MCU sub-grid, so
    the whole batch still decodes in ONE static-shape launch — host
    entropy decode is whole-image (serial bitstream), but device work,
    wire bytes, and the output scale with the CROP area, and there is no
    per-size recompilation and no bucketing requirement.  Pixels are
    bit-identical to the same slice of a full decode (tested).  Same
    ``scale``/``dtype``/``mean``/``std``/``mesh`` semantics as
    :func:`decode_same_size_batch_crops`.
    """
    norm = _norm_static(dtype, mean, std)
    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache
    ensure_compilation_cache()
    staged = _host_stage_crops(blobs, boxes, crop_hw, lane_tile, scale,
                               prepare_threads, wire, "decode_batch_crops",
                               align=_mesh_align(mesh, lane_tile),
                               same_size=False)
    return _dispatch_staged_crops(staged, lane_tile, scale, norm, mesh)


def iter_decode_batch_crops(
    crop_batches,
    crop_hw: Tuple[int, int],
    lane_tile: int = LANE_TILE,
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    prefetch: int = 2,
    dtype=None,
    mean=None,
    std=None,
    mesh=None,
    mixed_sizes: bool = False,
):
    """Streaming random-crop decode with host/device overlap.

    ``crop_batches`` yields ``(blobs, boxes)`` pairs; each yields exactly
    what :func:`decode_same_size_batch_crops` returns for that batch,
    while the host half of up to ``prefetch`` upcoming batches runs on
    worker threads — :func:`iter_decode_batches`'s overlap for the
    RandomResizedCrop training path (fixed ``crop_hw``/``scale`` keep one
    compiled program across batches).  ``dtype``/``mean``/``std`` fuse
    normalization into the decode program (see
    :func:`decode_same_size_batch`).  ``mixed_sizes=True`` admits
    batches of differently-sized images (see :func:`decode_batch_crops`;
    batches must then be internally uniform only in sampling MODE, and
    images within ~1 MCU of each other in grid size share one compiled
    program automatically since the covering sub-grid depends only on
    ``crop_hw``).
    """
    norm = _norm_static(dtype, mean, std)

    def stage_thunks():
        for blobs, boxes in crop_batches:
            yield functools.partial(
                _host_stage_crops, list(blobs), list(boxes), crop_hw,
                lane_tile, scale, prepare_threads, wire,
                "iter_decode_batch_crops", _mesh_align(mesh, lane_tile),
                not mixed_sizes)

    for staged in _prefetched(stage_thunks(), prefetch):
        yield _dispatch_staged_crops(staged, lane_tile, scale, norm, mesh)
