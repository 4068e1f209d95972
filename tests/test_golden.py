"""Golden regression pins: the bundled ILSVRC sample must decode to exactly
these bytes forever (oracle, device pipeline, and BMP serialization).

Any spec change (IDCT constants, color fixed point, clamps, BMP layout)
breaks these hashes on purpose — update them only with a deliberate,
documented spec change.
"""

import hashlib

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.io.bmp import encode_bmp
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle

ILSVRC_RGB_SHA256 = (
    "4fbf6066461fac0e070ee7e6bab48f948f96718d57b01619e67374e9af4e1f4e")
ILSVRC_BMP_SHA256 = (
    "1f12bfbfb9a18abd4fc608efc628aa1ebffad206f6fe7db11034aa6ffbcdeeae")


class TestGolden:
    def test_oracle_rgb_hash(self, ilsvrc_bytes):
        rgb = decode_bytes_oracle(ilsvrc_bytes).rgb
        assert rgb.shape == (375, 500, 3)
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == ILSVRC_RGB_SHA256

    def test_bmp_hash(self, ilsvrc_bytes):
        rgb = decode_bytes_oracle(ilsvrc_bytes).rgb
        assert hashlib.sha256(encode_bmp(rgb)).hexdigest() == ILSVRC_BMP_SHA256

    def test_tpu_pipeline_hash(self, ilsvrc_bytes):
        from pim_jpeg_decoder_tpu.models.pipeline import TpuJpegDecoder
        rgb = TpuJpegDecoder(lane_tile=128).decode(ilsvrc_bytes).rgb
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == ILSVRC_RGB_SHA256

    def test_engine_hash(self, ilsvrc_bytes):
        from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine
        engine = DecodeEngine(budget_mcus=4096, lane_tile=128, keep_rgb=True)
        report = engine.decode_named_blobs([("ilsvrc", ilsvrc_bytes)])
        assert report.results[0].ok
        assert hashlib.sha256(
            report.results[0].rgb.tobytes()).hexdigest() == ILSVRC_RGB_SHA256
