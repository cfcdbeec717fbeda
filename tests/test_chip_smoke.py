"""chip_smoke.py without a GPU: exits non-zero, last line says ok false."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert "cpu" in last["error"]
