"""Differential fuzz harness: random JPEGs, engine vs oracle, corruptions.

Three properties, checked over randomized streams:

1. DIFFERENTIAL: for any valid baseline/progressive JPEG the engine's
   pixels equal the NumPy oracle's bit-exactly (any divergence is a real
   bug in one of the three spec implementations).
2. ROBUSTNESS: truncations and byte flips of valid streams must produce
   either a successful decode or a clean per-file error — never a crash,
   hang, or poisoned sibling image.
3. API: the batch decoders reject mismatched inputs and accept every
   fixture they claim to.

Run:  python tools/fuzz.py [iterations] [seed] [fixed]
(CPU backend recommended: JAX_PLATFORMS=cpu; the device program runs there
with the identical integer arithmetic.  On the GPU pass ``fixed`` as the
3rd arg to pin one engine geometry, so random geometries do not each pay a
compile.)
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SAMPLINGS = ["4:4:4", "4:2:2", "4:4:0", "4:2:0"]


def random_jpeg(rng) -> tuple:
    """(name, bytes) — a random valid JPEG via the in-repo encoder or PIL."""
    from PIL import Image

    from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg

    h = int(rng.integers(8, 180))
    w = int(rng.integers(8, 180))
    kind = rng.integers(0, 3)
    if kind == 0:                       # smooth photo-like
        small = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3),
                             np.uint8)
        img = np.array(Image.fromarray(small).resize((w, h),
                                                     Image.BILINEAR))
    elif kind == 1:                     # hard noise
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
    else:                               # flat + edges
        img = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        img[h // 2:, :] = rng.integers(0, 256, 3, np.uint8)

    q = int(rng.integers(30, 99))
    if rng.random() < 0.25:             # PIL-encoded (independent encoder)
        buf = io.BytesIO()
        pil = Image.fromarray(img)
        if rng.random() < 0.3:
            pil = pil.convert("L")
        pil.save(buf, format="JPEG", quality=q,
                 subsampling=int(rng.integers(0, 3)),
                 progressive=bool(rng.random() < 0.3))
        return f"pil_q{q}", buf.getvalue()
    gray = rng.random() < 0.15
    app_segments = None
    comment = None
    if rng.random() < 0.2:     # exercise the APPn/COM skip paths
        app_segments = [bytes(rng.integers(0, 256,
                                           int(rng.integers(0, 300)),
                                           np.uint8))
                        for _ in range(int(rng.integers(1, 4)))]
    if rng.random() < 0.15:
        comment = bytes(rng.integers(32, 127, int(rng.integers(0, 200)),
                                     np.uint8))
    data = encode_jpeg(img[:, :, 0] if gray else img, quality=q,
                       sampling=str(rng.choice(SAMPLINGS)),
                       restart_interval=int(rng.choice([0, 0, 1, 3, 7])),
                       grayscale=gray,
                       zero_based_ids=bool(rng.random() < 0.1),
                       app_segments=app_segments, comment=comment)
    return f"enc_q{q}", data


def main() -> None:
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)

    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        # CPU campaigns get a virtual 8-device mesh so the engine's
        # multi-device path and the mesh= batch APIs fuzz alongside the
        # single-device ones (mesh_check below).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")

    from pim_jpeg_decoder_tpu.oracle.decoder import (
        decode_bytes_oracle,
        decode_scaled_oracle,
    )
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu.utils.config import EngineConfig

    # Small padding granules keep iterations fast.
    engine_tiles = [8, 32, 128]
    mesh_tiles = [8, 16]

    def random_engine():
        """Random engine geometry: exercises bucketing, dedicated
        launches, chunked (banded) decode, every transport/wire/scale."""
        lane_tile = int(rng.choice(engine_tiles))
        budget = lane_tile * int(rng.choice([4, 8, 16]))
        scale = int(rng.choice([1, 1, 1, 1, 2, 4, 8]))
        cfg = EngineConfig(
            budget_mcus=budget, lane_tile=lane_tile, prepare_threads=2,
            max_launch_mcus=int(rng.choice([budget, budget, 4 * budget])),
            transport=("auto" if scale != 1 else
                       str(rng.choice(["auto", "rgb", "ycbcr"]))),
            wire=str(rng.choice(["auto", "i16"])),
            scale=scale,
            max_images_per_batch=int(rng.choice([1, 4, 16])),
        )
        return DecodeEngine(keep_rgb=True, config=cfg)

    engine = DecodeEngine(keep_rgb=True, config=EngineConfig(
        budget_mcus=1024, lane_tile=128, prepare_threads=2))

    t0 = time.monotonic()
    stats = {"valid": 0, "mismatch": 0, "corrupt_ok": 0,
             "corrupt_decoded": 0, "stream_batches": 0, "table_trials": 0,
             "prog_table_trials": 0, "mesh_trials": 0,
             "mixed_crop_trials": 0,
             "failures": []}
    batch = []

    def stream_check() -> None:
        """Property 3 (streaming API): iter_decode_batches over random
        same-size batches must equal serial decode_same_size_batch."""
        from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
        from pim_jpeg_decoder_tpu.models.input_pipeline import (
            decode_same_size_batch,
            iter_decode_batches,
        )

        hh = int(rng.integers(16, 96))
        ww = int(rng.integers(16, 96))
        sampling = str(rng.choice(SAMPLINGS))
        batches = []
        for _ in range(int(rng.integers(2, 4))):
            imgs = [rng.integers(0, 256, (hh, ww, 3), np.uint8)
                    for _ in range(int(rng.integers(1, 4)))]
            batches.append([encode_jpeg(im, quality=int(rng.integers(50, 95)),
                                        sampling=sampling) for im in imgs])
        streamed = list(iter_decode_batches(
            batches, lane_tile=128,
            prefetch=int(rng.integers(1, 4))))
        assert len(streamed) == len(batches)
        for blobs_b, (out, _) in zip(batches, streamed):
            want, _ = decode_same_size_batch(blobs_b, lane_tile=128)
            if not np.array_equal(np.asarray(out), np.asarray(want)):
                stats["mismatch"] += 1
                stats["failures"].append(("stream", "streamed != serial"))
                return
        stats["stream_batches"] += len(batches)

    def mesh_check() -> None:
        """Property 6 (multi-chip batch APIs): decode_same_size_batch /
        _crops and the streaming iterator with mesh= on the virtual mesh
        must equal the single-device programs (random geometry, scale,
        lane tile, batch size — incl. batches that don't divide the
        mesh)."""
        import jax
        if len(jax.devices()) < 2:
            return
        from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
        from pim_jpeg_decoder_tpu.models.input_pipeline import (
            decode_same_size_batch,
            decode_same_size_batch_crops,
            iter_decode_batches,
        )
        from pim_jpeg_decoder_tpu.parallel.mesh import make_mesh

        ndev = len(jax.devices())
        n = int(rng.choice([d for d in (2, 4, 8) if d <= ndev]))
        mesh = make_mesh(n)
        hh = int(rng.integers(17, 80))
        ww = int(rng.integers(17, 80))
        sampling = str(rng.choice(SAMPLINGS))
        blobs = [encode_jpeg(rng.integers(0, 256, (hh, ww, 3), np.uint8),
                             quality=int(rng.integers(50, 95)),
                             sampling=sampling)
                 for _ in range(int(rng.integers(1, 6)))]
        lt = int(rng.choice(mesh_tiles))
        scale = int(rng.choice([1, 1, 2]))
        kw = dict(lane_tile=lt, scale=scale)
        out, _ = decode_same_size_batch(blobs, mesh=mesh, **kw)
        want, _ = decode_same_size_batch(blobs, **kw)
        if not np.array_equal(np.asarray(out), np.asarray(want)):
            stats["mismatch"] += 1
            stats["failures"].append(("mesh", "batch != single-device"))
            return
        if rng.random() < 0.5:
            (s_out, _), = list(iter_decode_batches([blobs], mesh=mesh,
                                                   **kw))
            if not np.array_equal(np.asarray(s_out), np.asarray(want)):
                stats["mismatch"] += 1
                stats["failures"].append(("mesh", "stream != single"))
                return
        # Random aligned crop box per image (per-image offsets below).
        def pick(extent):
            size = int(rng.integers(scale, extent + 1)) // scale * scale
            return max(size, scale)
        ch = pick(hh)
        cw = pick(ww)
        boxes = []
        for _ in blobs:
            y0 = int(rng.integers(0, hh - ch + 1)) // scale * scale
            x0 = int(rng.integers(0, ww - cw + 1)) // scale * scale
            boxes.append((y0, x0))
        ckw = dict(boxes=boxes, crop_hw=(ch, cw), lane_tile=lt,
                   scale=scale)
        c_out, _ = decode_same_size_batch_crops(blobs, mesh=mesh, **ckw)
        c_want, _ = decode_same_size_batch_crops(blobs, **ckw)
        if not np.array_equal(np.asarray(c_out), np.asarray(c_want)):
            stats["mismatch"] += 1
            stats["failures"].append(("mesh", "crops != single-device"))
            return
        stats["mesh_trials"] += 1

    def table_check() -> None:
        """Property 1 at the entropy level: random canonical Huffman
        tables + garbage payloads decode byte-identically (same output,
        or both error) through the native decoder and the Python oracle —
        including streams long enough to engage the guarded fast path
        (>= kBlockSlack bytes remaining), the window where a byte-budget
        bug once hid (see docs/entropy_fast_path.md)."""
        from pim_jpeg_decoder_tpu.codec.entropy import decode_scan
        from pim_jpeg_decoder_tpu.codec.header import (
            Component,
            HuffmanTableSpec,
            JpegError,
            JpegHeader,
        )
        from pim_jpeg_decoder_tpu.native import native_available
        from pim_jpeg_decoder_tpu.native.binding import decode_scan_cpp
        if not native_available():
            return

        def make_table(table_class, table_id):
            if rng.random() < 0.6:  # complete: dense success coverage
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
            else:  # sparse canonical: BAD_CODE coverage
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
            if table_class == 0:  # DC sizes incl. the invalid 12..15
                syms = rng.integers(0, 16, total).astype(np.uint8)
            else:  # AC: pair-able smalls + wide magnitudes incl. 11..15
                runs = rng.integers(0, 16, total)
                sizes = rng.choice([0, 1, 2, 3, 4, 9, 10, 12, 15], total)
                syms = (runs << 4 | sizes).astype(np.uint8)
            return HuffmanTableSpec(table_id, table_class, counts, syms)

        for _ in range(8):
            if rng.random() < 0.4:
                comps = [Component(0, 1, 1, 0, dc_id=0, ac_id=0)]
            else:
                v, h = int(rng.integers(1, 3)), int(rng.integers(1, 3))
                comps = [Component(0, h, v, 0, dc_id=0, ac_id=0),
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
            n = int(rng.integers(300, 4000) if rng.random() < 0.3
                    else rng.integers(16, 400))
            payload = rng.integers(0, 256, n, np.uint8)
            if rng.random() < 0.3:
                payload[rng.random(n) < 0.5] = 0  # long decodes
            header.entropy_bytes = payload.tobytes()
            if header.restart_interval:
                segs = -(-header.num_mcus // header.restart_interval)
                offs = sorted(int(x) for x in rng.integers(0, n, segs - 1))
                header.segment_offsets = tuple([0] + offs)
            else:
                header.segment_offsets = (0,)

            r_py = e_py = r_cc = e_cc = None
            try:
                r_py = decode_scan(header)
            except JpegError as e:
                e_py = str(e)
            try:
                r_cc = decode_scan_cpp(header)
            except JpegError as e:
                e_cc = str(e)
            if e_py is None and e_cc is None:
                if not np.array_equal(r_py, r_cc):
                    stats["mismatch"] += 1
                    stats["failures"].append(("table", "native != oracle"))
                    return
            elif e_py is None or e_cc is None:
                stats["mismatch"] += 1
                stats["failures"].append(
                    ("table", f"one path errored: py={e_py!r} cc={e_cc!r}"))
                return
            stats["table_trials"] += 1

    def prog_table_check() -> None:
        """Progressive differential at the scan-script level: random
        tables + random successive-approximation scripts (random band
        splits, overlaps/duplicates, refine chains, restart intervals)
        with garbage payloads — native image-level decode vs the Python
        oracle, same output or both error.  Dense coverage for the most
        complex native component (the G.2 fast paths + handoffs)."""
        from pim_jpeg_decoder_tpu.codec.header import (
            Component,
            JpegError,
            JpegHeader,
            ScanData,
            ScanSpec,
        )
        from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive
        from pim_jpeg_decoder_tpu.native import native_available
        from tests.test_native import TestRandomTableDifferential as T
        if not native_available():
            return

        for _ in range(6):
            safe = rng.random() < 0.8
            make = (T._complete_huffman if safe else T._random_huffman)
            dc = make(rng, 0, 0)
            ac = make(rng, 1, 0)
            header = JpegHeader(
                width=int(rng.integers(8, 64)),
                height=int(rng.integers(8, 48)),
                progressive=True,
                components=[Component(0, 1, 1, 0, dc_id=0, ac_id=0)],
                dc_tables={0: dc},
                ac_tables={0: ac},
            )

            def scan(spec, ri=0):
                n = int(rng.integers(800, 2400) if rng.random() < 0.2
                        else rng.integers(8, 300))
                data = rng.integers(0, 256, n, np.uint8).tobytes()
                if ri:
                    segs = max(1, -(-header.num_mcus // ri))
                    offs = sorted(
                        int(x) for x in rng.integers(0, n, segs - 1))
                    offs = tuple([0] + offs)
                else:
                    offs = (0,)
                is_dc = spec.start_of_selection == 0
                return ScanData([0], [0], [0], spec, ri, data, offs,
                                [dc if is_dc else None],
                                [None if is_dc else ac])

            a0 = int(rng.integers(0, 3))
            scans = [scan(ScanSpec(0, 0, 0, a0))]  # DC first (mandatory)
            al_dc = a0
            for _ in range(int(rng.integers(1, 7))):
                ri = int(rng.choice([0, 0, 0, 2, 5]))
                if rng.random() < 0.3 and al_dc > 0:  # DC refine chain
                    scans.append(scan(ScanSpec(0, 0, al_dc, al_dc - 1), ri))
                    al_dc -= 1
                else:  # AC band: random range, overlaps/dupes allowed
                    ss = int(rng.integers(1, 64))
                    se = int(rng.integers(ss, 64))
                    al = int(rng.integers(0, 3))
                    ah = 0 if rng.random() < 0.6 else al + 1
                    scans.append(scan(ScanSpec(ss, se, ah, al), ri))
            header.scans = scans

            r_py = e_py = r_cc = e_cc = None
            try:
                r_py = decode_progressive(header, use_native=False)
            except JpegError as e:
                e_py = str(e)
            # Half the trials run the component-chain partition (r5,
            # threads>1): output AND error reporting must match serial.
            threads = int(rng.integers(2, 4)) if rng.random() < 0.5 else 1
            try:
                r_cc = decode_progressive(header, use_native=True,
                                          threads=threads)
            except JpegError as e:
                e_cc = str(e)
            if e_py is None and e_cc is None:
                if not np.array_equal(r_py, r_cc):
                    stats["mismatch"] += 1
                    stats["failures"].append(
                        ("prog_table", "native != oracle"))
                    return
            elif e_py is None or e_cc is None:
                stats["mismatch"] += 1
                stats["failures"].append(
                    ("prog_table",
                     f"one path errored: py={e_py!r} cc={e_cc!r}"))
                return
            stats["prog_table_trials"] += 1

    def mixed_crop_check() -> None:
        """Property 7 (r5, mixed-size crop batches): decode_batch_crops
        over randomly-sized images must equal the per-image oracle slices
        (random crop size/origins, sampling, scale, lane tile)."""
        from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
        from pim_jpeg_decoder_tpu.models.input_pipeline import (
            decode_batch_crops,
        )

        sampling = str(rng.choice(SAMPLINGS))
        scale = int(rng.choice([1, 1, 1, 2]))
        # 8-multiples are automatically scale-multiples (scale <= 2 here).
        ch = int(rng.integers(2, 8)) * 8
        cw = int(rng.integers(2, 8)) * 8
        blobs, boxes = [], []
        for _ in range(int(rng.integers(2, 5))):
            hh = int(rng.integers(ch, ch + 90))
            ww = int(rng.integers(cw, cw + 90))
            blobs.append(encode_jpeg(
                rng.integers(0, 256, (hh, ww, 3), np.uint8),
                quality=int(rng.integers(55, 95)), sampling=sampling))
            y0 = int(rng.integers(0, hh - ch + 1)) // scale * scale
            x0 = int(rng.integers(0, ww - cw + 1)) // scale * scale
            boxes.append((y0, x0))
        lt = int(rng.choice(mesh_tiles))
        out, _ = decode_batch_crops(blobs, boxes, (ch, cw), scale=scale,
                                    lane_tile=lt)
        host = np.asarray(out)
        for i, (b, (y0, x0)) in enumerate(zip(blobs, boxes)):
            if scale == 1:
                want = decode_bytes_oracle(b).rgb[y0:y0 + ch, x0:x0 + cw]
            else:
                want = decode_scaled_oracle(b, scale)[
                    y0 // scale:(y0 + ch) // scale,
                    x0 // scale:(x0 + cw) // scale]
            if not np.array_equal(host[i], want):
                stats["mismatch"] += 1
                stats["failures"].append(
                    ("mixed_crop", f"image {i} != oracle slice"))
                return
        stats["mixed_crop_trials"] += 1

    for i in range(iters):
        if rng.random() < 0.02:
            stream_check()
        if rng.random() < 0.05:
            table_check()
        if rng.random() < 0.04:
            prog_table_check()
        if rng.random() < 0.03:
            mesh_check()
        if rng.random() < 0.03:
            mixed_crop_check()
        name, data = random_jpeg(rng)
        mode = rng.random()
        if mode < 0.7:
            batch.append((f"{i}_{name}", data))
        elif mode < 0.85 and len(data) > 4:   # truncate
            cut = int(rng.integers(2, len(data)))
            batch.append((f"{i}_trunc{cut}_{name}", data[:cut]))
        else:                                  # flip one byte
            pos = int(rng.integers(0, len(data)))
            mutated = bytearray(data)
            mutated[pos] ^= int(rng.integers(1, 256))
            batch.append((f"{i}_flip{pos}_{name}", bytes(mutated)))

        if len(batch) < 8 and i != iters - 1:
            continue
        if "fixed" not in sys.argv[3:] and rng.random() < 0.3:
            engine = random_engine()
        report = engine.decode_named_blobs(batch)
        for (bname, bdata), res in zip(batch, report.results):
            corrupted = "_trunc" in bname or "_flip" in bname
            if corrupted:
                # Never crashes (we got here); either outcome is legal,
                # but a successful decode must still be a sane raster.
                if res.ok:
                    stats["corrupt_decoded"] += 1
                    assert res.rgb.dtype == np.uint8 and res.rgb.ndim == 3
                else:
                    stats["corrupt_ok"] += 1
                    assert res.error
                continue
            stats["valid"] += 1
            if not res.ok:
                stats["mismatch"] += 1
                stats["failures"].append((bname, f"decode failed: {res.error}"))
                continue
            if engine.scale != 1:
                want = decode_scaled_oracle(bdata, engine.scale)
            else:
                want = decode_bytes_oracle(bdata).rgb
            if not np.array_equal(res.rgb, want):
                stats["mismatch"] += 1
                diff = int(np.abs(res.rgb.astype(int)
                                  - want.astype(int)).max())
                stats["failures"].append((bname, f"pixel diff max {diff}"))
        batch = []

    stats["seconds"] = round(time.monotonic() - t0, 1)
    stats["iterations"] = iters
    stats["ok"] = stats["mismatch"] == 0
    print(json.dumps(stats))
    sys.exit(0 if stats["ok"] else 1)


if __name__ == "__main__":
    main()
