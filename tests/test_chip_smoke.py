"""`chip_smoke.py`: refuses to run without a GPU, and its control flow holds
at rehearsal sizes on the CPU backend (the card run itself is
``python chip_smoke.py``; ``--four`` on four cards)."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd=REPO, devices=None, script=SCRIPT, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_chip_smoke_fails_without_gpu():
    r = _run([])
    assert r.returncode != 0
    assert "needs 1 NVIDIA GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_four_fails_without_gpus():
    r = _run(["--four"], devices=4)
    assert r.returncode != 0
    assert "needs 4 NVIDIA GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    r = _run(["--rehearse"], cwd=str(tmp_path), script=str(lone))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_rehearsal_one_device():
    r = _run(["--rehearse"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = _last_json(r.stdout)
    assert out["ok"] is True and out["rehearsal"] is True
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for phase in ("== A.", "== B.", "== C.", "== D."):
        assert phase in r.stdout
    assert r.stdout.count("[OK]") == 11 and "[FAIL]" not in r.stdout
    assert not os.path.exists(os.path.join(REPO, ".smoke_work"))


def test_chip_smoke_rehearsal_four_devices():
    r = _run(["--rehearse", "--four"], devices=4)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert _last_json(r.stdout)["device"]["count"] == 4
    for tag in ("dp:", "sp:", "cp:"):
        assert f"{tag} " in r.stdout and "byte-identical" in r.stdout
    assert "== A." not in r.stdout
