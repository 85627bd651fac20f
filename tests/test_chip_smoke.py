"""chip_smoke.py refuses to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_device_check_refuses_cpu():
    """In this CPU-only world the device check exits before any phase."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.phase_device()


def test_script_exits_nonzero_without_gpu():
    p = _run(ROOT / "chip_smoke.py", ROOT)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_script_alone_exits_nonzero(tmp_path):
    """Copied out of the checkout, the script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
