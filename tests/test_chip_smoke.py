"""chip_smoke.py's contract on the CPU: the rehearsal passes every phase
and names the CPU; a run without a GPU, or without the repository beside
the script, fails and prints no result. Subprocesses, so the script's own
CLI and platform handling are what is exercised."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("chips", [1, 4])
def test_chip_smoke_rehearsal_passes_on_cpu(tmp_path, chips):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    proc = _run([SCRIPT, "--rehearse", "--chips", str(chips)], tmp_path,
                env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": chips}}
    phases = [ln.split()[1].rstrip(":") for ln in lines
              if ln.startswith("[phase]")]
    assert phases == (["encode", "search", "ties_bf16", "main_path",
                       "gpu_tests"] if chips == 1 else ["mesh4"])
    assert "gpu" not in lines[-1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    if where == "repo":
        script = SCRIPT
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run([script], tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
