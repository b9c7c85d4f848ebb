"""Large-n GP regression sharded over a device mesh.

No reference equivalent — the reference is single-process NumPy throughout
(SURVEY.md C13-C16). This demo runs the scale-out path: X row-sharded over
the ``data`` mesh axis, kernel block-rows built per-chip, the posterior mean
solved with ring-matvec CG (K is never materialised globally), plus sharded
gradient-ascent restarts over the ``restart`` axis.

On a single-chip machine, emulate a mesh with:
    python examples/distributed_regression.py --force-cpu-devices 8
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse


def main() -> None:
    # persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache)
    from gaussian_process_tpu.utils.profiling import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--restarts", type=int, default=0,
                    help="if >0, also run this many sharded gradient restarts")
    ap.add_argument("--force-cpu-devices", type=int, default=0,
                    help="emulate an N-device CPU mesh (single-host demo)")
    ap.add_argument("--out", default="artifacts/distributed")
    args = ap.parse_args()

    if args.force_cpu_devices:
        # XLA_FLAGS is frozen at first backend init; this must run before any
        # device query (same pattern as __graft_entry__.dryrun_multichip).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.force_cpu_devices}"
            ).strip()
        import jax

        if os.environ.get("JAX_PLATFORMS", "cpu") != "cpu":
            jax.config.update("jax_platforms", "cpu")
            try:
                import jax.extend.backend as _jeb

                _jeb.clear_backends()
            except Exception:
                pass
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gaussian_process_tpu import gp, ops, parallel
    from gaussian_process_tpu.utils import datasets
    from gaussian_process_tpu.utils.logging import JsonlLogger
    from gaussian_process_tpu.utils.profiling import time_fn

    n_dev = len(jax.devices())
    mesh = parallel.make_mesh()
    print(f"devices: {n_dev}, mesh axes {mesh.axis_names} shape {mesh.devices.shape}")

    n = (args.n // n_dev) * n_dev  # row-sharding needs divisibility
    x_np, y_np = datasets.large_scale_regression(n, args.d)
    x = jnp.asarray(x_np)
    y = jnp.asarray(y_np)
    x_test = jnp.asarray(x_np[: args.n_test])

    kernel = ops.RBF()
    params = kernel.init_params()

    # full posterior (mean AND variance) via ring-matvec block CG
    solver = parallel.make_posterior_cg(kernel, mesh=mesh, noise_variance=1e-2)
    mean, var, alpha, iters, resnorm = solver(params, x, y, x_test)
    stats = time_fn(lambda: solver(params, x, y, x_test)[0], warmup=1, iters=3)

    os.makedirs(args.out, exist_ok=True)
    log = JsonlLogger(os.path.join(args.out, "run.jsonl"))
    log.log(
        "distributed_cg_done",
        n=n, d=args.d, devices=n_dev,
        cg_iters=int(iters), residual=float(resnorm),
        solve_ms=stats["min_s"] * 1e3,
        mean_predictive_std=float(jnp.mean(jnp.sqrt(var))),
    )
    print(f"n={n}: CG converged in {int(iters)} iters "
          f"(residual {float(resnorm):.2e}), solve {stats['min_s']*1e3:.1f} ms, "
          f"mean predictive std {float(jnp.mean(jnp.sqrt(var))):.4f}")

    # sanity: sharded mean matches trainings labels roughly at observed points
    err = float(jnp.mean(jnp.abs(mean - y[: args.n_test])))
    print(f"mean |mu - y| at observed points: {err:.4f}")
    log.log("fit_check", mean_abs_err=err)

    # the r5 production large-n path: Nyström-preconditioned SEGMENTED
    # distributed CG — bounded device calls, sharded-CGState checkpoints,
    # exact resume (parallel.distributed_posterior_cg_segmented); at the
    # 100k scale Jacobi CG stalls, so this is the path a real run takes
    mean_s, var_s, _alpha, it_s, res_s, _state = (
        parallel.distributed_posterior_cg_segmented(
            kernel, params, x, y, x_test, mesh=mesh, noise_variance=1e-2,
            preconditioner="nystrom", precond_rank=min(256, n // 4),
            segment_iters=20,
        )
    )
    seg_err = float(jnp.max(jnp.abs(mean_s - mean)))
    log.log("segmented_nystrom_done", cg_iters=int(it_s),
            residual=float(res_s), max_abs_diff_vs_jacobi_solver=seg_err)
    print(f"segmented Nyström CG: {int(it_s)} iters (vs {int(iters)} "
          f"Jacobi), residual {float(res_s):.2e}, |d mean| {seg_err:.2e}")

    if args.restarts:
        key = jax.random.key(0)
        ls = jax.random.uniform(key, (args.restarts,), minval=0.3, maxval=3.0)
        params_batch = {
            "sigma": jnp.ones(args.restarts),
            "lengthscale": ls,
        }
        sub = min(512, n)
        # restarts parallelise over their own all-device mesh axis
        restart_mesh = parallel.make_mesh(restart=n_dev, data=1)
        res_params, lml, _, _ = parallel.sharded_gradient_restarts(
            kernel, params_batch, x[:sub], y[:sub], mesh=restart_mesh,
            noise_variance=1e-2, max_iters=100,
        )
        best, best_lml = parallel.best_restart(res_params, lml)
        log.log("restarts_done", n_restarts=args.restarts,
                best_lml=float(best_lml), best_lengthscale=float(best["lengthscale"]))
        print(f"best of {args.restarts} restarts: "
              f"l={float(best['lengthscale']):.3f}, LML={float(best_lml):.2f}")
    log.close()


if __name__ == "__main__":
    main()
