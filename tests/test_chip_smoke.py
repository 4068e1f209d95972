"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions pass at a tiny size (the card runs them at full size)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

TINY = {"imagenet": (40, 56), "phone": (200, 264), "dri": (72, 96),
        "gray": (48, 64)}


def test_main_refuses_cpu(capsys):
    rc = chip_smoke.main([])
    out, err = capsys.readouterr()
    assert rc != 0
    assert "'cpu'" in err and "not 'gpu'" in err
    assert '"ok": true' not in out


def test_alone_without_the_package_fails(tmp_path):
    """Copied into a directory holding nothing else of the repository, the
    script exits non-zero and prints no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cannot start" in proc.stderr


def test_phase_programs_tiny():
    lines = []
    chip_smoke.phase_programs(m=16, log=lines.append)
    n_wires = 2
    assert len(lines) == (len(chip_smoke.MODE_KEYS)
                          * len(chip_smoke.PROGRAMS) * n_wires)
    assert all("bit-exact (quant max 65535)" in ln for ln in lines)
    assert sum("memory:" in ln for ln in lines) == (
        len(chip_smoke.PROGRAMS) * n_wires)


def test_phase_end_to_end_tiny():
    lines = []
    chip_smoke.phase_end_to_end(sizes=TINY, batch=4, crop=(32, 32),
                                card="cpu", log=lines.append)
    for path in ("cli", "engine", "decode_same_size_batch",
                 "decode_batch_crops", "decode_scaled"):
        assert any(ln.startswith(f"path {path}") and "bit-exact" in ln
                   for ln in lines), path


def test_phase_four_tiny():
    lines = []
    chip_smoke.phase_four(n=4, sizes=TINY, batch=8, crop=(32, 32),
                          lane_tile=8, log=lines.append)
    assert sum(ln.startswith("four:") for ln in lines) == 5


def test_phase_error_names_the_difference():
    import numpy as np
    with pytest.raises(chip_smoke.PhaseError, match="1 of 4 values differ"):
        chip_smoke._check(np.array([1, 2, 3, 4]), np.array([1, 2, 3, 5]),
                          "probe")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The full single-card run; needs an NVIDIA GPU (skips elsewhere)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          cwd=os.path.dirname(chip_smoke.__file__), env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
