"""Engine configuration.

The reference's only configuration is two compile-time Makefile knobs
(``NUM_TASKLETS`` / ``MAX_MCU_PER_DPU``, reference: Makefile:1-2) flowing as
-D defines into host and device code, plus ``metadata[19]`` re-shipping
MAX_MCU_PER_DPU at runtime (reference: src/decoder_host.cpp:172).  This is
the runtime equivalent: one dataclass, overridable from the environment and
the CLI, consumed by the engine / kernels / mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class EngineConfig:
    # Device batch: MCUs per launch (static shape; the reference's
    # MAX_MCU_PER_DPU x nr_dpus analogue).
    budget_mcus: int = 16384
    # MCU padding granule: every device batch holds a multiple of this
    # many MCUs (the reference's NUM_TASKLETS analogue).
    lane_tile: int = 512
    # Host entropy-decode threads (the reference has exactly one preparer
    # thread; the C++ path releases the GIL so more scale).
    prepare_threads: int = 4
    # Max images sharing one batch's quant-table pool.
    max_images_per_batch: int = 16
    # Mesh: number of chips to shard MCU tiles across (None = all local).
    num_devices: Optional[int] = None
    # Largest single device launch, in MCUs.  Images above this decode in
    # MCU-row-aligned chunks (bounded compiled-shape set + bounded device
    # memory for arbitrarily large inputs; the reference instead rejects
    # them — "Too high resolution", reference: src/decoder_host.cpp:146-149).
    max_launch_mcus: int = 65536
    # Decode at 1/scale resolution (reduced IDCT; 1 = full).
    scale: int = 1
    # Device->host output transport: "rgb" fetches decoded RGB (3 B/px);
    # "ycbcr" fetches level-shifted subsampled YCbCr planes (1.5 B/px for
    # 4:2:0) and finishes upsample+color on the host (bit-identical, C++
    # fast path); "auto" picks ycbcr whenever it reduces wire bytes
    # (every mode except 4:4:4).  D2H is the deployment bottleneck.
    transport: str = "auto"
    # Host->device coefficient wire: "auto" ships int8 when every
    # coefficient of the batch fits (true for virtually all q<=90 JPEGs -
    # measured 0 exceedances on the q75 corpus), HALVING H2D bytes; the
    # int8->int16 widening fuses into the on-device [M,g,64]->[g,64,M]
    # transpose the kernel needs anyway, so device work does not grow.
    # Batches with any |coeff| > 127 fall back to int16 (bit-exactness is
    # unconditional).  "i16" disables the compaction.  COLD-START NOTE: a
    # corpus mixing int8-fitting and overflowing batches compiles BOTH the
    # i8 and i16 programs per launch geometry (persistent-cached after) —
    # set PIM_JPEG_TPU_WIRE=i16 when first-run compile latency matters more
    # than H2D bytes.
    wire: str = "auto"

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        cfg = cls()
        mapping = {
            "PIM_JPEG_TPU_BUDGET_MCUS": ("budget_mcus", int),
            "PIM_JPEG_TPU_LANE_TILE": ("lane_tile", int),
            "PIM_JPEG_TPU_PREPARE_THREADS": ("prepare_threads", int),
            "PIM_JPEG_TPU_MAX_IMAGES": ("max_images_per_batch", int),
            "PIM_JPEG_TPU_NUM_DEVICES": ("num_devices", int),
            "PIM_JPEG_TPU_TRANSPORT": ("transport", str),
            "PIM_JPEG_TPU_WIRE": ("wire", str),
            "PIM_JPEG_TPU_MAX_LAUNCH": ("max_launch_mcus", int),
            "PIM_JPEG_TPU_SCALE": ("scale", int),
        }
        for env, (field, conv) in mapping.items():
            if env in os.environ:
                setattr(cfg, field, conv(os.environ[env]))
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.lane_tile <= 0 or self.lane_tile % 8:
            raise ValueError(f"lane_tile must be a positive multiple of 8, "
                             f"got {self.lane_tile}")
        if self.budget_mcus % self.lane_tile:
            raise ValueError(
                f"budget_mcus ({self.budget_mcus}) must be a multiple of "
                f"lane_tile ({self.lane_tile})")
        if self.prepare_threads < 1:
            raise ValueError("prepare_threads must be >= 1")
        if self.max_images_per_batch < 1:
            raise ValueError("max_images_per_batch must be >= 1")
        if self.transport not in ("auto", "rgb", "ycbcr"):
            raise ValueError(
                f"transport must be auto/rgb/ycbcr, got {self.transport!r}")
        if self.wire not in ("auto", "i16"):
            raise ValueError(f"wire must be auto/i16, got {self.wire!r}")
        if self.scale not in (1, 2, 4, 8):
            raise ValueError(f"scale must be 1, 2, 4 or 8, got {self.scale}")
        if self.scale != 1 and self.transport == "ycbcr":
            raise ValueError(
                "transport='ycbcr' is full-scale only (scaled decode emits "
                "reduced RGB, already fewer wire bytes); use transport="
                "'auto' or 'rgb' with scale != 1")
        if self.num_devices is not None and self.num_devices < 1:
            raise ValueError(
                f"num_devices must be >= 1, got {self.num_devices}")
        if self.max_launch_mcus < self.lane_tile:
            raise ValueError(
                f"max_launch_mcus ({self.max_launch_mcus}) must be >= "
                f"lane_tile ({self.lane_tile})")
        if self.budget_mcus > self.max_launch_mcus:
            # A packed batch dispatches as ONE launch, so the launch cap
            # bounds the packing budget too; clamp (lane-tile-aligned)
            # rather than raise so "cap my launches" via
            # PIM_JPEG_TPU_MAX_LAUNCH alone does what it says.
            self.budget_mcus = (self.max_launch_mcus
                                // self.lane_tile * self.lane_tile)
