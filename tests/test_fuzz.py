"""Seeded mini differential-fuzz regression (tools/fuzz.py in-process).

A deterministic slice of the fuzz campaign keeps the randomized-input
surface (two encoders x samplings x DRI x progressive x corruption
classes) exercised on every test run; the full campaigns run via
``python tools/fuzz.py`` (README "Tests / bench" describes them).
"""

import os
import subprocess
import sys
import json

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_seeded_mini_fuzz():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "fuzz.py"),
         "48", "1234"],
        capture_output=True, text=True, cwd=REPO, timeout=280, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    stats = json.loads(lines[-1])
    assert stats["ok"], stats
    assert stats["valid"] > 0 and stats["mismatch"] == 0
