"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The SURVEY.md section 4 substitute for distributed tests: conftest forces
``xla_force_host_platform_device_count=8``; the device decode runs per
shard under shard_map.
"""

import os

import numpy as np
import pytest

import jax

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.codec.entropy import decode_scan
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.models.pipeline import build_qpool
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus
from pim_jpeg_decoder_tpu.parallel.mesh import MCU_AXIS, make_mesh
from pim_jpeg_decoder_tpu.parallel.multihost import partition_paths
from pim_jpeg_decoder_tpu.parallel.sharding import decode_mcus_sharded

LANE_TILE = 8  # tiny padding granule keeps the CPU runs fast
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def eight_device_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    return make_mesh(8)


class TestShardedDecode:
    def test_matches_single_device(self, photo_image, eight_device_mesh):
        data = encode_jpeg(photo_image, quality=88, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        mode = S.mode_for(header.mode_key)

        n = 8 * LANE_TILE
        m_pad = -(-header.num_mcus // n) * n
        padded = np.zeros((m_pad, mode.g, 64), np.int16)
        padded[: header.num_mcus] = coeffs
        qidx = np.zeros(m_pad, np.int32)
        qpool = build_qpool([header], mode)

        sharded = np.asarray(decode_mcus_sharded(
            padded, qidx, qpool, mode, mesh=eight_device_mesh,
            lane_tile=LANE_TILE))
        single = np.asarray(decode_mcus(
            padded, qidx, qpool, mode, lane_tile=LANE_TILE))
        np.testing.assert_array_equal(sharded, single)

    def test_ycbcr_transport_matches(self, photo_image, eight_device_mesh):
        """Sharded YCbCr wire planes equal the single-device ones."""
        data = encode_jpeg(photo_image, quality=88, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        mode = S.mode_for(header.mode_key)

        n = 8 * LANE_TILE
        m_pad = -(-header.num_mcus // n) * n
        padded = np.zeros((m_pad, mode.g, 64), np.int16)
        padded[: header.num_mcus] = coeffs
        qidx = np.zeros(m_pad, np.int32)
        qpool = build_qpool([header], mode)

        sharded = np.asarray(decode_mcus_sharded(
            padded, qidx, qpool, mode, mesh=eight_device_mesh,
            lane_tile=LANE_TILE, ycbcr=True))
        single = np.asarray(decode_mcus(
            padded, qidx, qpool, mode, lane_tile=LANE_TILE, ycbcr=True))
        assert sharded.shape == (mode.g, 64, m_pad)
        np.testing.assert_array_equal(sharded, single)

    def test_output_sharding_layout(self, eight_device_mesh):
        mode = S.mode_for((1, 1, 3))
        m = 8 * LANE_TILE
        coeffs = np.zeros((m, 3, 64), np.int16)
        out = decode_mcus_sharded(coeffs, np.zeros(m, np.int32),
                                  np.ones((1, 3, 64), np.float32), mode,
                                  mesh=eight_device_mesh, lane_tile=LANE_TILE)
        # Output stays sharded over the MCU axis (no gather on device).
        spec = out.sharding.spec
        assert spec[0] == MCU_AXIS

    def test_shard_size_validation(self, eight_device_mesh):
        mode = S.mode_for((1, 1, 3))
        with pytest.raises(ValueError, match="multiple"):
            decode_mcus_sharded(
                np.zeros((8, 3, 64), np.int16), np.zeros(8, np.int32),
                np.ones((1, 3, 64), np.float32), mode,
                mesh=eight_device_mesh, lane_tile=LANE_TILE)


class TestGraftEntry:
    def test_entry_compiles(self, monkeypatch):
        monkeypatch.syspath_prepend(REPO_ROOT)
        import __graft_entry__ as ge
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[0] == args[0].shape[0]
        assert out.dtype == np.uint8

    @pytest.mark.parametrize("n", [2, 8])
    def test_dryrun_multichip(self, n, monkeypatch):
        monkeypatch.syspath_prepend(REPO_ROOT)
        import __graft_entry__ as ge
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} devices")
        ge.dryrun_multichip(n)


class TestMultihostHelpers:
    def test_partition_paths_strided_balanced(self):
        paths = [f"f{i}" for i in range(10)]
        shards = [partition_paths(paths, i, 3) for i in range(3)]
        assert sorted(sum(shards, [])) == sorted(paths)
        sizes = sorted(len(s) for s in shards)
        assert sizes == [3, 3, 4]


class TestInitializeDistributedGating:
    """initialize_distributed must not block a single-process run that merely
    sits inside a Slurm/MPI allocation (ADVICE r1): only markers implying
    MULTI-process intent may trigger jax.distributed.initialize."""

    def _call(self, monkeypatch, env):
        from pim_jpeg_decoder_tpu.parallel import multihost
        for var in ("JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID", "SLURM_NTASKS",
                    "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        calls = []
        monkeypatch.setattr(
            multihost.jax.distributed, "initialize",
            lambda **kw: calls.append(kw))
        multihost.initialize_distributed()
        return calls

    def test_bare_slurm_job_id_is_single_process(self, monkeypatch):
        assert self._call(monkeypatch, {"SLURM_JOB_ID": "123"}) == []

    def test_slurm_single_task_is_single_process(self, monkeypatch):
        assert self._call(monkeypatch, {"SLURM_JOB_ID": "123",
                                        "SLURM_NTASKS": "1"}) == []

    def test_ompi_size_one_is_single_process(self, monkeypatch):
        assert self._call(monkeypatch, {"OMPI_COMM_WORLD_SIZE": "1"}) == []

    def test_slurm_multi_task_initializes(self, monkeypatch):
        assert len(self._call(monkeypatch, {"SLURM_JOB_ID": "123",
                                            "SLURM_NTASKS": "4"})) == 1

    def test_ompi_multi_rank_initializes(self, monkeypatch):
        assert len(self._call(monkeypatch,
                              {"OMPI_COMM_WORLD_SIZE": "2"})) == 1

    def test_coordinator_env_initializes(self, monkeypatch):
        env = {"JAX_COORDINATOR_ADDRESS": "localhost:1234"}
        assert len(self._call(monkeypatch, env)) == 1

    def test_plain_env_is_noop(self, monkeypatch):
        assert self._call(monkeypatch, {}) == []


class TestShardedInt8Wire:
    def test_int8_wire_matches_int16(self, photo_image, eight_device_mesh):
        """decode_mcus_sharded preserves an int8 coefficient wire
        (batching.compact_wire) and decodes identically to int16."""
        from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg as enc
        data = enc(photo_image, quality=75, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        assert coeffs.min() >= -128 and coeffs.max() <= 127
        mode = S.mode_for(header.mode_key)

        n = 8 * LANE_TILE
        m_pad = -(-header.num_mcus // n) * n
        padded = np.zeros((m_pad, mode.g, 64), np.int16)
        padded[: header.num_mcus] = coeffs
        qidx = np.zeros(m_pad, np.int32)
        qpool = build_qpool([header], mode)

        from pim_jpeg_decoder_tpu.runtime.batching import compact_wire
        wire8 = compact_wire(padded)
        assert wire8.dtype == np.int8

        got = np.asarray(decode_mcus_sharded(
            wire8, qidx, qpool, mode, mesh=eight_device_mesh,
            lane_tile=LANE_TILE))
        want = np.asarray(decode_mcus_sharded(
            padded, qidx, qpool, mode, mesh=eight_device_mesh,
            lane_tile=LANE_TILE))
        np.testing.assert_array_equal(got, want)


    def test_preplaced_inputs_no_double_placement(self, photo_image,
                                                  eight_device_mesh):
        """place_for_mesh (the engine's producer-side H2D) feeds
        decode_mcus_sharded without a second placement, and the result
        still matches the oracle single-device decode."""
        from unittest.mock import patch

        from pim_jpeg_decoder_tpu.parallel.sharding import place_for_mesh
        from pim_jpeg_decoder_tpu.runtime.batching import compact_wire

        data = encode_jpeg(photo_image, quality=82, sampling="4:2:0")
        header = scan_jpeg(data)
        coeffs = decode_scan(header)
        mode = S.mode_for(header.mode_key)

        n = 8 * LANE_TILE
        m_pad = -(-header.num_mcus // n) * n
        padded = np.zeros((m_pad, mode.g, 64), np.int16)
        padded[: header.num_mcus] = coeffs
        qidx = np.zeros(m_pad, np.int32)
        qpool = build_qpool([header], mode)

        # Producer side: int8 wire + mesh placement (as _stage_batch does).
        wire = compact_wire(padded)
        placed = place_for_mesh(wire, qidx, qpool, eight_device_mesh)
        assert placed[0].dtype == np.int8  # wire preserved on placement

        real_put = jax.device_put
        calls = []

        def counting_put(x, *a, **kw):
            calls.append(x)
            return real_put(x, *a, **kw)

        with patch.object(jax, "device_put", side_effect=counting_put):
            sharded = np.asarray(decode_mcus_sharded(
                *placed, mode, mesh=eight_device_mesh,
                lane_tile=LANE_TILE))
        assert not calls, "decode_mcus_sharded re-placed placed inputs"

        single = np.asarray(decode_mcus(
            padded, qidx, qpool, mode, lane_tile=LANE_TILE))
        np.testing.assert_array_equal(sharded, single)


class TestSingleImageMeshAPIs:
    """VERDICT r4 item 7: the single-image latency APIs accept ``mesh=``
    and produce bit-identical pixels to their single-device dispatch."""

    def test_decoder_mesh_matches(self, photo_image, eight_device_mesh):
        from pim_jpeg_decoder_tpu.models.pipeline import TpuJpegDecoder
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        want = TpuJpegDecoder(lane_tile=LANE_TILE).decode(data).rgb
        got = TpuJpegDecoder(lane_tile=LANE_TILE,
                             mesh=eight_device_mesh).decode(data).rgb
        np.testing.assert_array_equal(got, want)

    def test_decoder_mesh_rgb_transport(self, photo_image,
                                        eight_device_mesh):
        from pim_jpeg_decoder_tpu.models.pipeline import TpuJpegDecoder
        data = encode_jpeg(photo_image, quality=85, sampling="4:4:4")
        want = TpuJpegDecoder(lane_tile=LANE_TILE).decode(data).rgb
        got = TpuJpegDecoder(lane_tile=LANE_TILE,
                             mesh=eight_device_mesh).decode(data).rgb
        np.testing.assert_array_equal(got, want)

    def test_decode_scaled_mesh_matches(self, photo_image,
                                        eight_device_mesh):
        from pim_jpeg_decoder_tpu.models.pipeline import decode_scaled
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        want = decode_scaled(data, 2, lane_tile=LANE_TILE)
        got = decode_scaled(data, 2, lane_tile=LANE_TILE,
                            mesh=eight_device_mesh)
        np.testing.assert_array_equal(got, want)

    def test_decode_region_mesh_matches(self, photo_image,
                                        eight_device_mesh):
        from pim_jpeg_decoder_tpu.models.pipeline import decode_region
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:2")
        want = decode_region(data, 17, 23, 64, 48, lane_tile=LANE_TILE)
        got = decode_region(data, 17, 23, 64, 48, lane_tile=LANE_TILE,
                            mesh=eight_device_mesh)
        np.testing.assert_array_equal(got, want)

    def test_decode_scaled_scale1_mesh(self, photo_image, eight_device_mesh):
        """scale=1 with mesh routes through the mesh-enabled full decode."""
        from pim_jpeg_decoder_tpu.models.pipeline import decode_scaled
        data = encode_jpeg(photo_image, quality=85, sampling="4:2:0")
        want = decode_scaled(data, 1, lane_tile=LANE_TILE)
        got = decode_scaled(data, 1, lane_tile=LANE_TILE,
                            mesh=eight_device_mesh)
        np.testing.assert_array_equal(got, want)
