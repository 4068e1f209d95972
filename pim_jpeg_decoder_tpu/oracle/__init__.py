"""The NumPy CPU oracle decoder — the bit-exactness reference for the engine.

The reference repo has no tests (SURVEY.md section 4); this package is the
test fixture factory and golden-output oracle the device pipeline is validated
against, plus a standalone correct CPU decoder in its own right.
"""

from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle, DecodedImage

__all__ = ["decode_bytes_oracle", "DecodedImage"]
