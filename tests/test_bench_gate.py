"""The bench parity gate must GATE (VERDICT r2 weak #2: round 2's 'gate'
only logged, which is exactly how an 85x parity regression shipped
silently). A deliberately degraded error pair must fail the run with a
nonzero exit; round-1-level parity must pass."""

import pytest


def _bench():
    import bench

    return bench


def test_gate_passes_at_round1_levels():
    b = _bench()
    # round-1 measured parity (BENCH_r01.json): mean 3.46e-4, lml 3.21e-5
    b.check_parity_gate(3.46e-4, 3.21e-5)


def test_gate_fails_on_round2_regression_levels():
    b = _bench()
    # round-2 regression (BENCH_r02.json): mean 1.56e-3, lml 2.74e-3 —
    # the exact failure the gate exists to catch, and it must exit nonzero
    with pytest.raises(SystemExit) as e:
        b.check_parity_gate(1.56e-3, 2.74e-3)
    assert e.value.code == 1


def test_gate_fails_on_lml_alone():
    b = _bench()
    with pytest.raises(SystemExit):
        b.check_parity_gate(1e-5, 5e-4)


def test_gate_fails_on_mean_alone():
    b = _bench()
    with pytest.raises(SystemExit):
        b.check_parity_gate(5e-3, 1e-6)


def test_gate_fails_closed_on_nan():
    # ADVICE r3 medium #1: `err > gate` is False for NaN, so the old
    # formulation let a totally broken run (NaN mean/LML) ship through the
    # gate. NaN in ANY position must now fail.
    b = _bench()
    nan = float("nan")
    for mean_err, lml_err in [(nan, 1e-6), (1e-5, nan), (nan, nan)]:
        with pytest.raises(SystemExit):
            b.check_parity_gate(mean_err, lml_err)
    with pytest.raises(SystemExit):
        b.check_parity_gate(1e-5, 1e-6, var_err=nan)


def test_gate_fails_on_var_alone():
    # ADVICE r3 low #4: variance is the one reduced-precision quantity
    # (HIGH v solve) — it needs its own gate.
    b = _bench()
    b.check_parity_gate(1e-5, 1e-6, var_err=1e-4)  # passes
    with pytest.raises(SystemExit):
        b.check_parity_gate(1e-5, 1e-6, var_err=5e-2)


def test_peaks_known_device():
    b = _bench()
    peaks = b.peak_rates("NVIDIA H100 80GB HBM3")
    assert peaks["tf32_tflops"] == 495.0 and peaks["hbm_tbps"] == 3.35


def test_peaks_unknown_device_raises():
    # an unknown device is an error, never a silent default peak
    b = _bench()
    with pytest.raises(KeyError):
        b.peak_rates("Some Other Accelerator")


def test_pct_peak_is_none_on_cpu():
    # a CPU run is never written under the name of a device metric
    b = _bench()
    assert b._pct_peak_tf32(1e3) is None


class TestRunBenchAllMerge:
    """run_bench_all must MERGE rows, never overwrite other modes'
    evidence (VERDICT r3 weak #2: a partial 2-mode re-run destroyed the
    committed 6-mode artifact)."""

    def _rba(self):
        import run_bench_all

        return run_bench_all

    def test_merge_replaces_only_rerun_mode(self):
        rba = self._rba()
        existing = [
            {"mode": "gram", "value": 0.7, "ok": True},
            {"mode": "solve", "value": 16.2, "ok": True},
            {"mode": "cg100k", "value": 7.5, "ok": True},
        ]
        out = rba.merge_rows(existing, "solve", [{"mode": "solve", "value": 15.0, "ok": True}])
        by_mode = {r["mode"]: r for r in out}
        assert by_mode["solve"]["value"] == 15.0
        assert by_mode["gram"]["value"] == 0.7  # untouched evidence survives
        assert by_mode["cg100k"]["value"] == 7.5
        assert len(out) == 3

    def test_failed_rerun_still_replaces_only_its_mode(self):
        rba = self._rba()
        existing = [{"mode": "gram", "value": 0.7, "ok": True},
                    {"mode": "solve", "value": 16.2, "ok": True}]
        out = rba.merge_rows(existing, "solve", [{"mode": "solve", "ok": False, "error": "timeout"}])
        by_mode = {r["mode"]: r for r in out}
        assert by_mode["gram"]["ok"] and not by_mode["solve"]["ok"]

    def test_load_existing_reads_only_the_out_file(self, tmp_path, monkeypatch):
        import json

        rba = self._rba()
        monkeypatch.chdir(tmp_path)
        with open("older.json", "w") as f:
            json.dump({"meta": {}, "rows": [{"mode": "gram", "ok": True}]}, f)
        assert rba._load_existing("bench_all.json") == []  # no seeding
        with open("bench_all.json", "w") as f:
            json.dump({"meta": {}, "rows": [{"mode": "solve", "ok": True}]}, f)
        assert rba._load_existing("bench_all.json") == [{"mode": "solve", "ok": True}]

    def test_parent_never_imports_jax(self):
        """The sweep's parent must leave the card to its bench.py children."""
        import os
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = ("import sys, run_bench_all; "
                "sys.exit(1 if 'jax' in sys.modules else 0)")
        assert subprocess.run([sys.executable, "-c", code], cwd=root).returncode == 0
