"""Multi-host loopback test: N processes on one machine, DCN over localhost
(SURVEY.md §4, strategy item 4; component C15).

The reference has no distributed communication of any kind — this validates
the replacement (jax.distributed + global meshes + collectives)
end-to-end without a cluster: process-spanning mesh, cross-host sharded LML
against a float64 oracle, host barriers, per-rank checkpointing.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_loopback(tmp_path):
    nproc = 2
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # workers configure their own emulated device count
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coord, str(nproc), str(i), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, f"worker {i} output:\n{out}"


_KILL_WORKER = os.path.join(_REPO, "tests", "multihost_kill_worker.py")


def test_kill_one_host_detect_and_redispatch():
    """Fault injection (SURVEY.md §5): 3 processes, rank 2 dies abruptly.
    Survivors must get a raise from the barrier (failure DETECTION) and then
    re-dispatch the dead host's candidates on a surviving mesh (elastic
    RECOVERY via parallel/recovery.py)."""
    nproc = 3
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _KILL_WORKER, coord, str(nproc), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    assert procs[2].returncode == 17, f"victim exit:\n{outs[2]}"
    for i in (0, 1):
        out = outs[i]
        assert procs[i].returncode == 0, f"survivor {i} failed:\n{out}"
        assert f"DETECTED {i}" in out, f"survivor {i} never detected:\n{out}"
        assert f"SURVIVOR_OK {i}" in out, f"survivor {i} no recovery:\n{out}"
    assert "recovered=1" in outs[0]
