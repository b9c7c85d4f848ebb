"""Hyperparameter tuning for GP regression: gradient ascent vs Bayesian opt.

[ref: tune_hyperparms_regression.py:435-461 (__main__): N=3 train, n=100
test; BO over lengthscale (3 iterations, PI acquisition) and gradient ascent
on the hand-derived RBF lengthscale gradient, ending with the cross-method
LML-agreement print at :456-461 — the reference's closest thing to a test].

Differences: the gradient path is jax.grad through the LML (no hand-derived
dK/dl), the whole ascent loop is one compiled lax.while_loop, and all four
acquisitions (PI/EI/UCB/TS) are genuinely dispatched (fixing quirk Q5).

Run: python examples/tune_hyperparms_regression.py [--acquisition PI]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax.numpy as jnp
import numpy as np

from gaussian_process_tpu import gp, ops, opt
from gaussian_process_tpu.utils import datasets, plotting
from gaussian_process_tpu.utils.logging import JsonlLogger


def main() -> None:
    # persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache)
    from gaussian_process_tpu.utils.profiling import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=3)
    ap.add_argument("--n-test", type=int, default=100)
    ap.add_argument("--acquisition", choices=["PI", "EI", "UCB", "TS"], default="PI")
    ap.add_argument("--compare-acquisitions", action="store_true",
                    help="run all four acquisitions and emit the comparison "
                         "artifact (the reference plots four curves that are "
                         "secretly all PI -- quirk Q5)")
    ap.add_argument("--bo-iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/tune_hyperparms")
    args = ap.parse_args()

    _, x_train, y_train, x_test = datasets.sine_regression(
        args.n_train, args.n_test, seed=args.seed
    )
    kernel = ops.RBF()
    xtr = jnp.asarray(x_train, jnp.float32)
    ytr = jnp.asarray(y_train, jnp.float32)

    # --- gradient ascent: jax.grad through the LML, lengthscale only
    # [ref: tune_hyperparms_regression.py:398-415 trains only l]
    params0 = kernel.init_params()
    ga = opt.tune_gradient_ascent(
        kernel, params0, xtr, ytr,
        noise_variance=5e-4, learning_rate=0.01, tol=1e-3, max_iters=10000,
        trainable={"sigma": False, "lengthscale": True},
    )
    lml_ga = float(ga.lml)
    l_ga = float(ga.params["lengthscale"])

    # --- Bayesian optimisation over the lengthscale
    # [ref: tune_hyperparms_regression.py:418-432: candidates in (0, 10)]
    def objective(theta: np.ndarray) -> float:
        p = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(theta[0])}
        return float(
            gp.log_marginal_likelihood(kernel, p, xtr, ytr, noise_variance=5e-4)
        )

    acqs = ["PI", "EI", "UCB", "TS"] if args.compare_acquisitions else [args.acquisition]
    results = {}
    for acq in acqs:
        results[acq] = opt.tune_bayesian_opt(
            objective,
            initial_points=np.array([[1.0]]),
            bounds=(np.array([0.05]), np.array([10.0])),
            n_iterations=args.bo_iters,
            n_candidates=100,
            acquisition=acq,
            seed=args.seed,
        )
    bo = max(results.values(), key=lambda r: r.best_value)
    lml_bo = bo.best_value
    l_bo = float(bo.best_params[0])

    # cross-method agreement [ref: tune_hyperparms_regression.py:456-461]
    rel_err = abs(lml_bo - lml_ga) / max(abs(lml_ga), 1e-12) * 100.0

    os.makedirs(args.out, exist_ok=True)
    with JsonlLogger(os.path.join(args.out, "run.jsonl")) as log:
        log.log("gradient_ascent_done", lengthscale=l_ga, lml=lml_ga, iters=int(ga.iters))
        log.log("bo_done", lengthscale=l_bo, lml=lml_bo,
                acquisition=args.acquisition, evaluations=len(bo.values))
        log.log("cross_method_agreement", rel_err_pct=rel_err)

    if args.compare_acquisitions:
        curves = {a: np.maximum.accumulate(r.values) for a, r in results.items()}
        plotting.plot_acquisition_comparison(
            curves, os.path.join(args.out, "acquisition_comparison.png"),
            best_line=lml_ga, title="1-D BO: PI vs EI vs UCB vs TS",
        )
        for a, r in results.items():
            print(f"BO({a:3s}): l = {float(r.best_params[0]):.4f}, "
                  f"LML = {r.best_value:.6f} ({len(r.values)} evals)")
    plotting.plot_bo_progress(
        bo.values, os.path.join(args.out, "bo_progress.png"), best_line=lml_ga,
        title=f"BO ({args.acquisition}) vs gradient ascent",
    )
    trace = np.asarray(ga.lml_trace)
    plotting.plot_convergence(
        np.abs(np.diff(trace[np.isfinite(trace)])) + 1e-300,
        os.path.join(args.out, "ascent.png"), title="gradient-ascent |dLML|",
    )

    print(f"gradient ascent: l = {l_ga:.4f}, LML = {lml_ga:.6f} ({int(ga.iters)} iters)")
    print(f"BO ({args.acquisition}): l = {l_bo:.4f}, LML = {lml_bo:.6f} ({len(bo.values)} evals)")
    print(f"error rate between BO and gradient ascent: {rel_err:.4f}%")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
