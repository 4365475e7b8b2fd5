"""chip_smoke.py refuses to run, and prints no result, without a GPU or
without the package beside it."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


def test_chip_smoke_fails_without_gpu():
    r = _run(ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert _no_result(r.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert _no_result(r.stdout)
