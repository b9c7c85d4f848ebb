"""chip_smoke.py's contract where there is no GPU: it exits non-zero and
prints no result; and its phase check fails closed."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_exits_nonzero_without_gpu():
    proc = _run(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "needs 1 GPU" in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


@pytest.mark.parametrize("err,ok", [(1e-6, True), (2e-5, True), (3e-5, False),
                                    (float("nan"), False)])
def test_phase_check_fails_closed(capsys, err, ok):
    sys.path.insert(0, ROOT)
    import chip_smoke

    if ok:
        chip_smoke._finish_phase("t", 0.0, {"e": (err, 2e-5)})
    else:
        with pytest.raises(SystemExit):
            chip_smoke._finish_phase("t", 0.0, {"e": (err, 2e-5)})
    assert json.loads(capsys.readouterr().out)["ok"] is ok
