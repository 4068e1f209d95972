"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device behavior is tested without a GPU cluster via
``xla_force_host_platform_device_count`` (SURVEY.md section 4), the standard
JAX substitute for distributed tests.  Tests marked ``gpu`` need an NVIDIA
card and skip elsewhere (see the ``gpu_card`` fixture).
"""

import os

# Must be set before jax initializes its backends; tests run on the virtual
# 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
from PIL import Image


@pytest.fixture()
def gpu_card():
    """Skip unless an NVIDIA GPU is visible.  Asked of nvidia-smi, not of
    JAX: the tests' own JAX is pinned to the CPU, so a ``gpu`` test runs
    its card work in a child process that is the card's only user."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi lists none)")


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def photo_image():
    """A smooth 'photographic' RGB test image (low-frequency content)."""
    small = np.random.default_rng(7).integers(0, 256, (15, 20, 3), dtype=np.uint8)
    return np.array(Image.fromarray(small).resize((160, 120), Image.BILINEAR))


@pytest.fixture(scope="session")
def noise_image():
    """A hard, high-frequency RGB test image."""
    return np.random.default_rng(8).integers(0, 256, (96, 88, 3), dtype=np.uint8)


@pytest.fixture(scope="session")
def ilsvrc_bytes():
    """The reference repo's bundled sample image, if available."""
    path = "/root/reference/ILSVRC2012_val_00000001.JPEG"
    if not os.path.exists(path):
        pytest.skip("reference sample image not available")
    with open(path, "rb") as f:
        return f.read()
