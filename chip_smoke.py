"""Start-up proof of the decode engine on the GPU, checked bit for bit.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards of one host: the sharded
                                  # paths against the same calls on one card

With no option it
  1. compiles every device program the engine picks at a 16,384-MCU launch
     (each sampling mode; RGB and YCbCr transports; int8 and int16
     coefficient wires; scales 2, 4 and 8) and compares each once with the
     NumPy oracle, one pool image carrying quant entries up to 65535;
  2. decodes a seeded corpus (ImageNet-sized 500x375 images, a 4032x3024
     phone photo, a restart-interval image, a grayscale image) through the
     CLI, the engine, the device-resident batch API, the mixed-size crop
     API and the scaled decode, comparing every output with the oracle.

It prints the JAX device, the card's name and power limit, one line per
phase, and as its last line ``{"ok": true, "device": {...}}``.  It exits
non-zero without that line when JAX finds no GPU (there is no CPU
fallback), when it does not run from a checkout of the repository, or when
any phase fails.  Everything runs in this one process: a second JAX
process could not reserve the card's memory.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH_MCUS = 16384
MODE_KEYS = ((1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 2, 3), (1, 1, 1))
# (transport, scale) pairs the engine compiles: full-scale RGB and YCbCr,
# and reduced-IDCT RGB.
PROGRAMS = (("rgb", 1), ("ycbcr", 1), ("rgb", 2), ("rgb", 4), ("rgb", 8))
QUANT_MAX = 65535      # largest 16-bit DQT entry


class PhaseError(Exception):
    """A phase's output differs from the oracle, or its set-up failed."""


def _package():
    """Import the decoder from the checkout this script lives in."""
    try:
        import pim_jpeg_decoder_tpu as pkg
    except ImportError as e:
        raise PhaseError(f"the decoder package is not next to "
                         f"{os.path.basename(__file__)}: {e}") from e
    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != HERE:
        raise PhaseError(f"imported the decoder from {where}, not from "
                         f"this checkout")
    return pkg


def device_facts() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, read without JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(out.stdout.split("\n")).strip(" |") or (
        f"nvidia-smi gave nothing (rc={out.returncode})")


def _check(got, want, what: str) -> None:
    got = np.asarray(got)
    if got.shape != want.shape:
        raise PhaseError(f"{what}: shape {got.shape} != oracle {want.shape}")
    if not np.array_equal(got, want):
        bad = int(np.count_nonzero(got != want))
        raise PhaseError(f"{what}: {bad} of {want.size} values differ "
                         f"from the oracle")


# -- phase 1: every device program at launch width ---------------------------

def synthetic_launch(mode, m: int, rng, images: int = 16):
    """One packed launch: int8-range coefficients (so both wires carry the
    same values), ``images`` quant tables, the last with entries up to
    QUANT_MAX."""
    coeffs = rng.integers(-128, 128, (m, mode.g, 64)).astype(np.int16)
    coeffs[:, :, 16:] //= 4          # photo-like spectrum, zero-heavy tail
    qpool = rng.integers(1, 100, (images, mode.g, 64)).astype(np.float32)
    qpool[-1] = rng.integers(1, QUANT_MAX + 1, (mode.g, 64))
    qpool[-1, :, -1] = QUANT_MAX
    qidx = (np.arange(m) * images // m).astype(np.int32)
    return coeffs, qidx, qpool


def phase_programs(m: int = LAUNCH_MCUS, seed: int = 0, log=print) -> None:
    import jax

    from pim_jpeg_decoder_tpu.ops import specs as S
    from pim_jpeg_decoder_tpu.ops.decode_kernel import _decode_mcus_jit
    from pim_jpeg_decoder_tpu.oracle.decoder import device_planes_oracle
    from pim_jpeg_decoder_tpu.utils.jaxtools import ensure_compilation_cache

    ensure_compilation_cache()
    rng = np.random.default_rng(seed)
    for key in MODE_KEYS:
        mode = S.mode_for(key)
        coeffs, qidx, qpool = synthetic_launch(mode, m, rng)
        dqidx, dqpool = jax.device_put(qidx), jax.device_put(qpool)
        wires = {"i8": jax.device_put(coeffs.astype(np.int8)),
                 "i16": jax.device_put(coeffs)}
        for transport, scale in PROGRAMS:
            ycbcr = transport == "ycbcr"
            want = device_planes_oracle(coeffs, qidx, qpool, mode, scale,
                                        ycbcr)
            for wire, dcoeffs in wires.items():
                what = (f"{mode.name} {transport} scale={scale} wire={wire} "
                        f"M={m}")
                t0 = time.perf_counter()
                compiled = _decode_mcus_jit.lower(
                    dcoeffs, dqidx, dqpool, mode=mode, raw=not ycbcr,
                    ycbcr=ycbcr, scale=scale).compile()
                t_compile = time.perf_counter() - t0
                _check(compiled(dcoeffs, dqidx, dqpool), want, what)
                line = (f"program {what}: compile {t_compile:.2f} s, "
                        f"bit-exact (quant max {int(qpool.max())})")
                if key == (2, 2, 3):
                    ma = compiled.memory_analysis()
                    line += (f"; memory: args {ma.argument_size_in_bytes} B,"
                             f" out {ma.output_size_in_bytes} B, temp "
                             f"{ma.temp_size_in_bytes} B, code "
                             f"{ma.generated_code_size_in_bytes} B")
                log(line)


# -- phase 2: the main path end to end ----------------------------------------

# Corpus geometry (rows, cols): ImageNet's median 500x375 photo, a 12 MP
# phone photo, and two smaller special cases.
FULL_SIZES = {"imagenet": (375, 500), "phone": (3024, 4032),
              "dri": (768, 1024), "gray": (480, 640)}


def synth_photo(rng, h: int, w: int) -> np.ndarray:
    """Smooth, photo-like RGB: upsampled low-resolution colour field plus
    gradients and mild noise (made in bulk from the seed)."""
    lo = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
    ys = np.linspace(0, lo.shape[0] - 1.001, h)
    xs = np.linspace(0, lo.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (lo[y0][:, x0] * (1 - fy) * (1 - fx)
           + lo[y0 + 1][:, x0] * fy * (1 - fx)
           + lo[y0][:, x0 + 1] * (1 - fy) * fx
           + lo[y0 + 1][:, x0 + 1] * fy * fx)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_corpus(seed: int, sizes=FULL_SIZES, distinct: int = 16,
                with_oracle: bool = True, log=print) -> dict:
    """Seeded JPEG corpus from the in-repo encoder, with oracle decodes
    (``corpus["oracle"][blob]``) unless ``with_oracle`` is False."""
    from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
    from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    ih, iw = sizes["imagenet"]
    corpus = {
        "imagenet420": [encode_jpeg(synth_photo(rng, ih, iw),
                                    quality=int(rng.integers(70, 96)),
                                    sampling="4:2:0")
                        for _ in range(distinct)],
        "imagenet444": [encode_jpeg(synth_photo(rng, ih, iw), quality=90,
                                    sampling="4:4:4") for _ in range(4)],
        "phone": encode_jpeg(synth_photo(rng, *sizes["phone"]), quality=90,
                             sampling="4:2:0"),
        "dri": encode_jpeg(synth_photo(rng, *sizes["dri"]), quality=85,
                           sampling="4:2:0", restart_interval=8),
        "gray": encode_jpeg(synth_photo(rng, *sizes["gray"])[..., 1],
                            quality=85, grayscale=True),
    }
    t1 = time.perf_counter()
    oracle = {}
    for name, blobs in corpus.items():
        for blob in (blobs if isinstance(blobs, list) else [blobs]):
            if with_oracle:
                oracle[blob] = decode_bytes_oracle(blob).rgb
    log(f"corpus: {sum(len(v) if isinstance(v, list) else 1 for v in corpus.values())}"
        f" distinct JPEGs, encode {t1 - t0:.1f} s, oracle "
        f"{time.perf_counter() - t1:.1f} s")
    corpus["oracle"] = oracle
    return corpus


def _mixed_files(corpus) -> list:
    """The CLI/engine corpus: ImageNet-sized 4:2:0 and 4:4:4, the phone
    photo, the restart-interval image and the grayscale image."""
    return (corpus["imagenet420"][:8] + corpus["imagenet444"]
            + [corpus["phone"], corpus["dri"], corpus["gray"]])


def run_cli(corpus, log=print) -> float:
    from pim_jpeg_decoder_tpu import cli
    from pim_jpeg_decoder_tpu.io.bmp import read_bmp

    blobs = _mixed_files(corpus)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = []
        for i, blob in enumerate(blobs):
            paths.append(os.path.join(tmp, f"img{i:03d}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(blob)
        t0 = time.perf_counter()
        rc = cli.main(paths + ["--quiet"])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise PhaseError(f"cli exited {rc}")
        for path, blob in zip(paths, blobs):
            _check(read_bmp(path[:-4] + ".bmp"), corpus["oracle"][blob],
                   f"cli {os.path.basename(path)}")
    log(f"path cli: {len(blobs)} files -> BMP, bit-exact")
    return wall


def run_engine(corpus, log=print) -> float:
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    blobs = _mixed_files(corpus)
    engine = DecodeEngine(config=EngineConfig.from_env(), keep_rgb=True)
    t0 = time.perf_counter()
    report = engine.decode_named_blobs(
        [(f"img{i}", b) for i, b in enumerate(blobs)])
    wall = time.perf_counter() - t0
    for res, blob in zip(report.results, blobs):
        if not res.ok:
            raise PhaseError(f"engine {res.name}: {res.error}")
        _check(res.rgb, corpus["oracle"][blob], f"engine {res.name}")
    log(f"path engine (transport={engine.transport}, wire={engine.wire}): "
        f"{len(blobs)} images, {len(report.launch_stats)} launch "
        f"geometries, bit-exact")
    return wall


def run_batch(corpus, batch: int = 256, log=print) -> float:
    import jax

    from pim_jpeg_decoder_tpu.models.input_pipeline import (
        decode_same_size_batch,
    )

    distinct = corpus["imagenet420"]
    blobs = [distinct[i % len(distinct)] for i in range(batch)]
    t0 = time.perf_counter()
    out, headers = decode_same_size_batch(blobs)
    out.block_until_ready()
    wall = time.perf_counter() - t0
    platforms = {d.platform for d in out.devices()}
    if platforms != {jax.devices()[0].platform}:
        raise PhaseError(f"batch not device-resident: {platforms}")
    host = np.asarray(out)
    for i, blob in enumerate(blobs):
        _check(host[i], corpus["oracle"][blob], f"batch image {i}")
    log(f"path decode_same_size_batch: {batch} x {host.shape[1]}x"
        f"{host.shape[2]}, {sum(h.num_mcus for h in headers)} MCUs, "
        f"device-resident, bit-exact")
    return wall


def _crop_inputs(corpus, crop, seed):
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg

    blobs = (corpus["imagenet420"][:8]
             + [corpus["phone"], corpus["dri"]])
    rng = np.random.default_rng(seed)
    boxes = []
    for blob in blobs:
        header = scan_jpeg(blob)
        h, w = header.height, header.width
        boxes.append((int(rng.integers(0, h - crop[0] + 1)),
                      int(rng.integers(0, w - crop[1] + 1))))
    return blobs, boxes


def run_crops(corpus, crop=(224, 224), seed: int = 0, log=print) -> float:
    from pim_jpeg_decoder_tpu.models.input_pipeline import decode_batch_crops

    blobs, boxes = _crop_inputs(corpus, crop, seed)
    t0 = time.perf_counter()
    out, _ = decode_batch_crops(blobs, boxes, crop)
    host = np.asarray(out)
    wall = time.perf_counter() - t0
    for i, (blob, (y0, x0)) in enumerate(zip(blobs, boxes)):
        want = corpus["oracle"][blob][y0:y0 + crop[0], x0:x0 + crop[1]]
        _check(host[i], want, f"crop {i}")
    log(f"path decode_batch_crops: {len(blobs)} mixed-size 4:2:0 images, "
        f"{crop[0]}x{crop[1]} crops, bit-exact")
    return wall


def run_scaled(corpus, scale: int = 4, log=print) -> float:
    from pim_jpeg_decoder_tpu.models.pipeline import decode_scaled
    from pim_jpeg_decoder_tpu.oracle.decoder import decode_scaled_oracle

    blob = corpus["phone"]
    t0 = time.perf_counter()
    got = decode_scaled(blob, scale)
    wall = time.perf_counter() - t0
    _check(got, decode_scaled_oracle(blob, scale), f"decode_scaled 1/{scale}")
    log(f"path decode_scaled: 1/{scale} of {corpus['oracle'][blob].shape[1]}"
        f"x{corpus['oracle'][blob].shape[0]} -> {got.shape[1]}x"
        f"{got.shape[0]}, bit-exact")
    return wall


def phase_end_to_end(seed: int = 0, sizes=FULL_SIZES, batch: int = 256,
                     crop=(224, 224), card: str = "", log=print) -> None:
    corpus = make_corpus(seed, sizes, log=log)
    walls = {
        "cli": run_cli(corpus, log=log),
        "engine": run_engine(corpus, log=log),
        "batch": run_batch(corpus, batch, log=log),
        "crops": run_crops(corpus, crop, seed, log=log),
        "scaled": run_scaled(corpus, log=log),
    }
    log(f"wall seconds, first call incl. compile, information only "
        f"({card}): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))


# -- --four: the sharded paths against one card ------------------------------

def phase_four(n: int = 4, seed: int = 0, sizes=FULL_SIZES, batch: int = 64,
               crop=(224, 224), lane_tile: int = 512, log=print) -> None:
    import jax

    from pim_jpeg_decoder_tpu.models.input_pipeline import (
        decode_batch_crops,
        decode_same_size_batch,
    )
    from pim_jpeg_decoder_tpu.models.pipeline import TpuJpegDecoder
    from pim_jpeg_decoder_tpu.ops import specs as S
    from pim_jpeg_decoder_tpu.parallel.mesh import make_mesh
    from pim_jpeg_decoder_tpu.parallel.sharding import decode_mcus_sharded
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    if len(jax.devices()) < n:
        raise PhaseError(f"--four needs {n} devices, JAX has "
                         f"{len(jax.devices())}")
    mesh = make_mesh(n)
    corpus = make_corpus(seed, sizes, distinct=8, with_oracle=False,
                         log=log)

    def on_all_cards(arr, what):
        cards = {s.device for s in arr.addressable_shards}
        if len(cards) != n:
            raise PhaseError(f"{what}: shards on {len(cards)} devices, "
                             f"not {n}")

    # The engine: all local cards against num_devices=1.
    blobs = _mixed_files(corpus)
    items = [(f"img{i}", b) for i, b in enumerate(blobs)]
    outs = {}
    for k in (1, n):
        engine = DecodeEngine(config=EngineConfig.from_env(num_devices=k),
                              keep_rgb=True)
        report = engine.decode_named_blobs(items)
        bad = [r for r in report.results if not r.ok]
        if bad:
            raise PhaseError(f"engine on {k} device(s): {bad[0].error}")
        outs[k] = [r.rgb for r in report.results]
    for i, (a, b) in enumerate(zip(outs[1], outs[n])):
        _check(b, a, f"engine image {i}, {n} cards vs 1")
    log(f"four: engine, {len(items)} images, {n} cards == 1 card")

    # The MCU-sharded device decode lands on every card.
    mode = S.mode_for((2, 2, 3))
    coeffs, qidx, qpool = synthetic_launch(mode, lane_tile * n,
                                           np.random.default_rng(seed))
    out = decode_mcus_sharded(coeffs, qidx, qpool, mode, mesh=mesh,
                              lane_tile=lane_tile, raw=True)
    on_all_cards(out, "decode_mcus_sharded")
    log(f"four: decode_mcus_sharded output shards on {n} cards")

    distinct = corpus["imagenet420"]
    bblobs = [distinct[i % len(distinct)] for i in range(batch)]
    got, _ = decode_same_size_batch(bblobs, mesh=mesh)
    on_all_cards(got, "decode_same_size_batch")
    want, _ = decode_same_size_batch(bblobs)
    _check(got, np.asarray(want), f"decode_same_size_batch x{batch}")
    log(f"four: decode_same_size_batch, {batch} images, shards on {n} "
        f"cards, {n} cards == 1 card")

    cblobs, boxes = _crop_inputs(corpus, crop, seed)
    got, _ = decode_batch_crops(cblobs, boxes, crop, mesh=mesh)
    want, _ = decode_batch_crops(cblobs, boxes, crop)
    _check(got, np.asarray(want), "decode_batch_crops")
    log(f"four: decode_batch_crops, {len(cblobs)} crops, {n} cards == 1 card")

    for name in ("phone", "dri", "gray"):
        got = TpuJpegDecoder(mesh=mesh).decode(corpus[name]).rgb
        _check(got, TpuJpegDecoder().decode(corpus[name]).rgb,
               f"TpuJpegDecoder {name}")
    log(f"four: TpuJpegDecoder phone/dri/gray, {n} cards == 1 card")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card paths and their "
                             "one-card comparison")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    try:
        _package()
        facts = device_facts()
    except Exception as e:  # no package, no backend: no result line
        print(f"chip_smoke: cannot start: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    print(f"device: platform={facts['platform']} kind={facts['kind']} "
          f"count={facts['count']}", flush=True)
    if facts["platform"] != "gpu":
        print(f"chip_smoke: JAX platform is {facts['platform']!r}, not "
              f"'gpu'; this check has no CPU fallback", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    def log(msg):
        print(msg, flush=True)

    if args.four:
        phases = [("four", functools.partial(phase_four, seed=args.seed,
                                             log=log))]
    else:
        phases = [
            ("programs", functools.partial(phase_programs, seed=args.seed,
                                           log=log)),
            ("end_to_end", functools.partial(phase_end_to_end,
                                             seed=args.seed, card=card,
                                             log=log)),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception as e:  # report every phase, fail at the end
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s:"
                f" {type(e).__name__}: {e}")
            continue
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_facts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
