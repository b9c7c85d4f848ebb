#!/usr/bin/env python3
"""Smoke test of the GP engine on NVIDIA GPUs, at real sizes.

Drives the package's main entry points once, in one process, and checks
each against a plain reference. Phases (one card, the default):

  solve    gp.posterior, RBF, n=8192 train, m=2048 test, d=4, f32, against
           the float64 NumPy/SciPy oracle of bench.py (bench.py's gates);
           one jax.grad of gp.log_marginal_likelihood against a float64
           gradient taken on the card.
  matvec   the fused kernel matvec K(X, X) @ V at n=102400, d=4,
           r in {1, 16}, RBF and Matern-3/2, against the XLA row-block
           matvec in float64 on the card.
  cg       gp.posterior_cg at n=102400, m=8, Nystrom rank 2048, tol 1e-3
           (bench.py's cg100k settings): converged; the same solver at
           n=4096 against dense gp.posterior; and the fused matvec timed
           against the XLA matvec at r=16 and r=2049.
  laplace  gp.laplace_fit_cg + gp.predict_binary_cg at n=102400, m=2048
           (bench.py's laplace100k settings); at n=4096 against the dense
           gp.fit_binary path.

``--four-cards`` runs only the multi-card phases on a data=4 mesh: the
distributed posterior (n=16384), the distributed posterior CG (n=102400,
Nystrom) and the distributed Laplace fit + predict (n=32768), each through
the jitted builders behind parallel.distributed_posterior,
distributed_posterior_cg and distributed_fit_predict_binary, against the
single-card entry point on the same data.

Each phase prints one JSON line (name, end-to-end seconds closed by
block_until_ready, errors beside their limits, precision). A failed phase
exits non-zero at once. The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no result.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32_PRECISION = (
    "f32 inputs; XLA dots at HIGHEST (FP32) where the package asks for it, "
    "TF32 where it does not; fused matvec: TF32x3 tensor-core dot"
)


def _line(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _finish_phase(name: str, seconds: float, errors: dict, **extra) -> None:
    """Print the phase line; exit 1 unless every error is within its limit
    (``not (err <= limit)`` so NaN fails)."""
    ok = all(err <= lim for err, lim in errors.values())
    _line({
        "phase": name, "ok": ok, "seconds": seconds,
        "errors": {k: {"value": e, "limit": lim} for k, (e, lim) in errors.items()},
        "precision": F32_PRECISION, **extra,
    })
    if not ok:
        raise SystemExit(1)


def _timed(fn, *args, reps: int = 1):
    """(result, best seconds of ``reps`` warm calls, first-call seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best, first


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _absmax(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda z: jnp.asarray(z, jnp.float64), tree)


def _cg_data(n: int, d: int = 4):
    rng = np.random.default_rng(0)
    x = rng.uniform(-5.0, 5.0, (n, d))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * rng.standard_normal(n)
    return x, y


def _binary_data(n: int, m: int):
    rng = np.random.default_rng(0)
    x = rng.uniform(-3.0, 3.0, (n, 2))
    y = np.where(np.sin(1.5 * x[:, 0]) - x[:, 1] > 0.0, 1.0, -1.0)
    xt = rng.uniform(-3.0, 3.0, (m, 2))
    return x, y, xt


# ------------------------------------------------------------- one card


def phase_solve(n: int = 8192, m: int = 2048) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from gaussian_process_tpu import gp, ops

    x, y, xt = bench._make_data(n, m, bench.D)
    _, base = bench._baseline_numpy_solve(x, y, xt)
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(bench.SIGMA), "lengthscale": jnp.float32(bench.LENGTHSCALE)}
    xtr, ytr, xte = (jnp.asarray(a, jnp.float32) for a in (x, y, xt))

    @jax.jit
    def solve(xtr, ytr, xte):
        post = gp.posterior(kernel, params, xtr, ytr, xte, noise_variance=bench.NOISE)
        return post.mean, post.var, post.lml

    (mean, var, lml), seconds, first = _timed(solve, xtr, ytr, xte, reps=3)
    mean_err, lml_err, var_err = bench.solve_errors(
        np.asarray(mean), np.asarray(var), lml, base
    )

    def lml_fn(p, xs, ys):
        return gp.log_marginal_likelihood(kernel, p, xs, ys, noise_variance=bench.NOISE)

    grad = jax.jit(jax.grad(lml_fn))
    g32, g_seconds, _ = _timed(grad, params, xtr, ytr)
    g64 = grad(_f64(params), jnp.asarray(x), jnp.asarray(y))
    leaves32 = np.array([float(v) for v in jax.tree_util.tree_leaves(g32)])
    leaves64 = np.array([float(v) for v in jax.tree_util.tree_leaves(g64)])
    _finish_phase(
        "solve", seconds,
        {
            "rel_mean": (mean_err, bench.PARITY_GATE_REL_MEAN),
            "rel_lml": (lml_err, bench.PARITY_GATE_REL_LML),
            "rel_var": (var_err, bench.PARITY_GATE_REL_VAR),
            "rel_lml_grad_vs_f64": (_rel(leaves32, leaves64), 1e-3),
        },
        n=n, m=m, first_call_seconds=first, grad_seconds=g_seconds,
        grad_finite=bool(np.all(np.isfinite(leaves32))),
    )
    if not np.all(np.isfinite(leaves32)):
        raise SystemExit(1)


def phase_matvec(n: int = 102400, widths=(1, 16)) -> None:
    import jax
    import jax.numpy as jnp

    from gaussian_process_tpu import ops

    x, _ = _cg_data(n)
    x32, x64 = jnp.asarray(x, jnp.float32), jnp.asarray(x)
    rng = np.random.default_rng(1)
    errors, times = {}, {}
    t_total = 0.0
    for kernel in (ops.RBF(), ops.Matern(nu=1.5)):
        name = f"{type(kernel).__name__}{getattr(kernel, 'nu', '')}"
        params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(2.0)}
        for r in widths:
            v = rng.standard_normal((n, r))
            ref = jax.jit(lambda a, w: ops.xla_matvec(kernel, _f64(params), a, a, w))(
                x64, jnp.asarray(v)
            )
            fused = jax.jit(lambda a, w: ops.gram_matvec(kernel, params, a, None, w, use_pallas=True))
            xla = jax.jit(lambda a, w: ops.gram_matvec(kernel, params, a, None, w, use_pallas=False))
            v32 = jnp.asarray(v, jnp.float32)
            out, t_f, _ = _timed(fused, x32, v32, reps=3)
            _, t_x, _ = _timed(xla, x32, v32, reps=3)
            t_total += t_f
            errors[f"{name}_r{r}_rel"] = (_rel(out, ref), 2e-5)
            times[f"{name}_r{r}"] = {"fused_s": t_f, "xla_f32_s": t_x}
    _finish_phase("matvec", t_total, errors, n=n, d=4, times=times,
                  reference="XLA row-block matvec, float64, on the card")


def phase_cg(n: int = 102400, m: int = 8, rank: int = 2048, tol: float = 1e-3,
             n_parity: int = 4096, max_iters: int = 120) -> None:
    import jax
    import jax.numpy as jnp

    from gaussian_process_tpu import gp, ops

    x, y = _cg_data(n)
    xd, yd = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    xt = xd[:m] + 0.1
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(2.0)}
    noise = 1e-2

    def solver(use_pallas):
        @jax.jit
        def run(xd, yd, xt):
            post = gp.posterior_cg(
                kernel, params, xd, yd, xt, noise_variance=noise, tol=tol,
                max_iters=max_iters, test_chunk=m, preconditioner="nystrom",
                precond_rank=rank, use_pallas=use_pallas,
            )
            return post.mean, post.var, post.iters, post.resnorm
        return run

    (mean, var, iters, resnorm), seconds, first = _timed(solver(None), xd, yd, xt)
    _, seconds_xla, _ = _timed(solver(False), xd, yd, xt)
    # cg_solve stops at tol * max-column ||[y | K_s]||
    Ks = np.asarray(ops.gram(kernel, params, xd, xt), np.float64)
    rhs = np.concatenate([y[:, None], Ks], axis=1)
    stop = tol * float(np.sqrt(np.max(np.sum(rhs * rhs, axis=0))))

    # fused against XLA matvec, one product each, at r=16 and r=2049
    matvec_s = {}
    rng = np.random.default_rng(2)
    for r in (16, 2049):
        v = jnp.asarray(rng.standard_normal((n, r)), jnp.float32)
        row = {}
        for label, use in (("fused", True), ("xla", False)):
            f = jax.jit(lambda a, w, use=use: ops.gram_matvec(
                kernel, params, a, None, w, use_pallas=use))
            row[f"{label}_s"] = _timed(f, xd, v, reps=2)[1]
        row["auto_path"] = ops.matvec_path(kernel, xd, r)
        matvec_s[f"r{r}"] = row

    xs, ys = xd[:n_parity], yd[:n_parity]
    dense = jax.jit(lambda a, b, c: gp.posterior(kernel, params, a, b, c, noise_variance=noise))(xs, ys, xt)
    small = jax.jit(lambda a, b, c: gp.posterior_cg(
        kernel, params, a, b, c, noise_variance=noise, tol=1e-8, test_chunk=m,
        preconditioner="nystrom", precond_rank=512))(xs, ys, xt)
    _finish_phase(
        "cg", seconds,
        {
            "resnorm_over_stop": (float(resnorm) / stop, 1.0),
            "iters_over_cap": (int(iters) / max_iters, 1.0 - 1.0 / max_iters),
            "abs_mean_vs_dense_n4096": (_absmax(small.mean, dense.mean), 1e-2),
            "abs_var_vs_dense_n4096": (_absmax(small.var, dense.var), 1e-2),
        },
        n=n, m=m, rank=rank, tol=tol, iters=int(iters), first_call_seconds=first,
        seconds_xla_matvec=seconds_xla, matvec_seconds=matvec_s,
        finite=bool(np.all(np.isfinite(np.asarray(mean))) and np.all(np.isfinite(np.asarray(var)))),
    )


def phase_laplace(n: int = 102400, m: int = 2048, rank: int = 512,
                  cg_tol: float = 1e-4, test_chunk: int = 512,
                  n_parity: int = 4096) -> None:
    import jax
    import jax.numpy as jnp

    from gaussian_process_tpu import gp, ops

    x, y, xt = _binary_data(n, m)
    xd, yd, xtd = (jnp.asarray(a, jnp.float32) for a in (x, y, xt))
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)}

    def pipeline(precond_rank):
        @jax.jit
        def run(xd, yd, xtd):
            st = gp.laplace_fit_cg(kernel, params, xd, yd, cg_tol=cg_tol,
                                   precond_rank=precond_rank)
            pred = gp.predict_binary_cg(kernel, params, st, xd, xtd,
                                        cg_tol=cg_tol, test_chunk=test_chunk)
            return st.iters, st.inner_iters, st.converged, pred.prob, pred.label
        return run

    (iters, inner, conv, prob, _), seconds, first = _timed(pipeline(rank), xd, yd, xtd)
    xs, ys = xd[:n_parity], yd[:n_parity]

    @jax.jit
    def dense(xs, ys, xtd):
        st = gp.fit_binary(kernel, params, xs, ys)
        pred = gp.predict_binary(kernel, params, st, xs, xtd)
        return pred.prob, pred.label

    dprob, dlabel = dense(xs, ys, xtd)
    _, _, _, cprob, clabel = pipeline(min(rank, n_parity))(xs, ys, xtd)
    prob64, _ = dense(*(jnp.asarray(a[:n_parity]) for a in (x, y)), jnp.asarray(xt))
    prob = np.asarray(prob)
    _finish_phase(
        "laplace", seconds,
        {
            "max_abs_prob_vs_dense_n4096": (_absmax(cprob, dprob), 5e-3),
            "label_disagreement_n4096": (float(np.mean(np.asarray(clabel) != np.asarray(dlabel))), 1e-3),
            "not_converged": (0.0 if bool(conv) else 1.0, 0.0),
            "nonfinite_prob": (float(np.mean(~np.isfinite(prob))), 0.0),
        },
        n=n, m=m, newton_iters=int(iters), inner_cg_iters=int(inner),
        first_call_seconds=first,
        f64_dense_n4096={"max_abs_prob_cg": _absmax(cprob, prob64),
                         "max_abs_prob_dense_f32": _absmax(dprob, prob64)},
    )


# ----------------------------------------------------------- four cards


def _sharded(mesh, a):
    """``a`` row-sharded over the mesh's data axis, checked to span every
    card of the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = jax.device_put(a, NamedSharding(mesh, P("data")))
    devices = {s.device for s in out.addressable_shards}
    if len(devices) != mesh.size:
        raise SystemExit(f"shards sit on {len(devices)} devices, not {mesh.size}")
    return out


def phase_dist_posterior(mesh, n: int = 16384, m: int = 2048,
                         noise: float = 1e-2) -> None:
    """Noise 1e-2, as bench.py's ``scaling`` mode: with the solve phase's
    5e-4 at n=16384, f32 itself misses the mean gate on one device (5.7e-4
    against float64, CPU f32), so that problem cannot judge the mesh."""
    import jax
    import jax.numpy as jnp

    import bench
    from gaussian_process_tpu import gp, ops, parallel

    x, y, xt = bench._make_data(n, m, bench.D)
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)}
    xd, yd = _sharded(mesh, jnp.asarray(x, jnp.float32)), _sharded(mesh, jnp.asarray(y, jnp.float32))
    xtd = jnp.asarray(xt, jnp.float32)
    solver = parallel.make_distributed_posterior(kernel, mesh=mesh, noise_variance=noise)
    (mean, var, lml, _), seconds, first = _timed(solver, params, xd, yd, xtd)
    one = jax.jit(lambda a, b, c: (lambda q: (q.mean, q.var, q.lml))(
        gp.posterior(kernel, params, a, b, c, noise_variance=noise)))
    (m1, v1, l1), seconds_1, _ = _timed(one, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), xtd)
    m64, v64, l64 = one(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))

    def as_base(mu, va, lm):
        return {"mean": np.asarray(mu, np.float64), "var": np.asarray(va, np.float64), "lml": float(lm)}

    mean_err, lml_err, var_err = bench.solve_errors(
        np.asarray(mean), np.asarray(var), lml, as_base(m1, v1, l1))
    _finish_phase(
        "dist_posterior", seconds,
        {"rel_mean_vs_1card": (mean_err, bench.PARITY_GATE_REL_MEAN),
         "rel_lml_vs_1card": (lml_err, bench.PARITY_GATE_REL_LML),
         "rel_var_vs_1card": (var_err, bench.PARITY_GATE_REL_VAR)},
        n=n, m=m, noise=noise, cards=mesh.size, seconds_1card=seconds_1,
        first_call_seconds=first,
        rel_mean_lml_var_vs_f64={
            "4card": bench.solve_errors(np.asarray(mean), np.asarray(var), lml, as_base(m64, v64, l64)),
            "1card": bench.solve_errors(np.asarray(m1), np.asarray(v1), l1, as_base(m64, v64, l64)),
        },
    )


def phase_dist_cg(mesh, n: int = 102400, m: int = 8, rank: int = 2048,
                  tol: float = 1e-3) -> None:
    import jax
    import jax.numpy as jnp

    from gaussian_process_tpu import gp, ops, parallel

    x, y = _cg_data(n)
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(2.0)}
    noise = 1e-2
    x32, y32 = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    xt = x32[:m] + 0.1
    solver = parallel.make_posterior_cg(
        kernel, mesh=mesh, noise_variance=noise, tol=tol, max_iters=120,
        preconditioner="nystrom", precond_rank=rank)
    (mean, var, _alpha, iters, _res), seconds, first = _timed(
        solver, params, _sharded(mesh, x32), _sharded(mesh, y32), xt)
    one = jax.jit(lambda a, b, c: (lambda q: (q.mean, q.var))(gp.posterior_cg(
        kernel, params, a, b, c, noise_variance=noise, tol=tol, max_iters=120,
        test_chunk=m, preconditioner="nystrom", precond_rank=rank)))
    (m1, v1), seconds_1, _ = _timed(one, x32, y32, xt)
    # The variance is diag(K_ss) minus a quadratic form of the CG solution,
    # so its error scales with the prior variance, not with the (small)
    # posterior variance; and block CG stops on the widest column (y),
    # leaving the K_s columns looser than tol.
    prior = float(np.max(np.asarray(ops.gram_diag(kernel, params, xt))))
    _finish_phase(
        "dist_cg", seconds,
        {"rel_mean_vs_1card": (_rel(mean, m1), 10 * tol),
         "var_vs_1card_over_prior_var": (_absmax(var, v1) / prior, 10 * tol)},
        rel_var_vs_1card=_rel(var, v1),
        n=n, m=m, rank=rank, tol=tol, iters=int(iters), cards=mesh.size,
        seconds_1card=seconds_1, first_call_seconds=first,
    )


def phase_dist_binary(mesh, n: int = 32768, m: int = 2048, rank: int = 512,
                      cg_tol: float = 1e-5, newton_tol: float = 1e-5) -> None:
    """Judged against the dense float64 fit on one card, bench.py's
    laplace oracle; the single-card CG fit is reported beside it. The
    predictive mean sums the gradient at the mode over all n points, so
    it amplifies the mode's error: with laplace100k's cg_tol=1e-4 and the
    default Newton tolerance, both f32 fits miss float64 by 5e-3 to 1e-2
    in probability at n=16384 (CPU f32) and by 0.03-0.11 at n=32768 (H100),
    while at 1e-5 they agree with it to ~1e-4 (CPU f32, n=16384)."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_tpu import gp, ops, parallel

    x, y, xt = _binary_data(n, m)
    kernel = ops.RBF()
    params = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)}
    x32, y32, xt32 = (jnp.asarray(a, jnp.float32) for a in (x, y, xt))
    fit = parallel.make_distributed_laplace_fit(
        kernel, mesh=mesh, tol=newton_tol, cg_tol=cg_tol, precond_rank=rank)
    predict = parallel.make_distributed_laplace_predict(
        kernel, mesh=mesh, cg_tol=cg_tol, precond_rank=rank)

    def run(a, b, c):
        _f, grad, sw, _i, _ii, _c = fit(params, a, b)
        return predict(params, a, grad, sw, c)

    (_m, _v, prob, _pa, label), seconds, first = _timed(
        run, _sharded(mesh, x32), _sharded(mesh, y32), xt32)

    @jax.jit
    def one(a, b, c):
        st = gp.laplace_fit_cg(kernel, params, a, b, tol=newton_tol, cg_tol=cg_tol,
                               precond_rank=rank)
        pred = gp.predict_binary_cg(kernel, params, st, a, c, cg_tol=cg_tol)
        return pred.prob, pred.label

    (p1, l1), seconds_1, _ = _timed(one, x32, y32, xt32)

    @jax.jit
    def dense64(a, b, c):
        st = gp.fit_binary(kernel, params, a, b)
        pred = gp.predict_binary(kernel, params, st, a, c)
        return pred.prob, pred.label

    p64, l64 = dense64(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))

    def disagree(a, b):
        return float(np.mean(np.asarray(a) != np.asarray(b)))

    _finish_phase(
        "dist_binary", seconds,
        {"max_abs_prob_vs_f64_dense": (_absmax(prob, p64), 5e-3),
         "label_disagreement_vs_f64_dense": (disagree(label, l64), 1e-3)},
        n=n, m=m, rank=rank, cg_tol=cg_tol, newton_tol=newton_tol,
        cards=mesh.size, seconds_1card=seconds_1, first_call_seconds=first,
        vs_1card={"max_abs_prob": _absmax(prob, p1), "label_disagreement": disagree(label, l1)},
        one_card_vs_f64_dense={"max_abs_prob": _absmax(p1, p64), "label_disagreement": disagree(l1, l64)},
    )


# ----------------------------------------------------------------- main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card phases on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, HERE)
    jax.config.update("jax_enable_x64", True)  # float64 references
    from gaussian_process_tpu.utils import profiling

    profiling.enable_persistent_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    if args.four_cards:
        from gaussian_process_tpu import parallel

        mesh = parallel.make_mesh(restart=1, data=4, devices=devices[:4])
        phase_dist_posterior(mesh)
        phase_dist_cg(mesh)
        phase_dist_binary(mesh)
    else:
        phase_solve()
        phase_matvec()
        phase_cg()
        phase_laplace()
    _line({"ok": True, "device": {"platform": devices[0].platform,
                                  "kind": devices[0].device_kind,
                                  "count": len(devices)}})


if __name__ == "__main__":
    main()
