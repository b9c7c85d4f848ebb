"""Exact GP regression on the sine dataset — the reference's headline demo.

[ref: GP_regression.py:300-315 (__main__): N=5 train, n=100 test, RBF
sigma=1, l=1, noise 5e-4; prior sampling, posterior mean/band, plots]

Run: python examples/gp_regression.py [--out /tmp/gp_out] [--kernel rbf|periodic|linear]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_tpu import gp, ops
from gaussian_process_tpu.utils import datasets, plotting
from gaussian_process_tpu.utils.logging import JsonlLogger


def main() -> None:
    # persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache)
    from gaussian_process_tpu.utils.profiling import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=5)
    ap.add_argument("--n-test", type=int, default=100)
    ap.add_argument("--kernel", choices=["rbf", "periodic", "linear"], default="rbf")
    ap.add_argument("--noise", type=float, default=5e-4)
    ap.add_argument("--num-functions", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/gp_regression")
    args = ap.parse_args()

    true_fn, x_train, y_train, x_test = datasets.sine_regression(
        args.n_train, args.n_test, seed=args.seed
    )
    kernel = {"rbf": ops.RBF, "periodic": ops.Periodic, "linear": ops.Linear}[args.kernel]()
    params = kernel.init_params()

    xtr = jnp.asarray(x_train, jnp.float32)
    ytr = jnp.asarray(y_train, jnp.float32)
    xte = jnp.asarray(x_test, jnp.float32)

    key = jax.random.key(args.seed)
    kp, ks = jax.random.split(key)
    prior_paths = gp.sample_prior(
        kernel, params, xte, kp, num_functions=args.num_functions, jitter=args.noise
    )
    post = gp.posterior(kernel, params, xtr, ytr, xte, noise_variance=args.noise)
    post_paths = gp.sample_posterior(
        kernel, params, post, xte, ks, num_functions=args.num_functions
    )

    os.makedirs(args.out, exist_ok=True)
    with JsonlLogger(os.path.join(args.out, "run.jsonl")) as log:
        log.log(
            "regression_done",
            kernel=args.kernel,
            n_train=args.n_train,
            n_test=args.n_test,
            lml=float(post.lml),
            mean_abs_err=float(jnp.mean(jnp.abs(post.mean - jnp.asarray(true_fn(x_test))))),
            jitter=float(post.jitter),
        )

    plotting.plot_gp_band(
        x_test, np.asarray(post.mean), np.asarray(post.std),
        os.path.join(args.out, "posterior.png"),
        x_train=x_train, y_train=y_train,
        samples=np.asarray(post_paths).T, true_fn=true_fn,
        title=f"GP posterior ({args.kernel})",
    )
    plotting.plot_gp_band(
        x_test, np.zeros(args.n_test), np.sqrt(np.asarray(ops.gram_diag(kernel, params, xte))),
        os.path.join(args.out, "prior.png"),
        samples=np.asarray(prior_paths).T, title=f"GP prior ({args.kernel})",
    )
    plotting.plot_kernel_matrix(
        np.asarray(ops.gram(kernel, params, xte)), os.path.join(args.out, "kernel.png"),
        title=f"{args.kernel} kernel on test grid",
    )

    print(f"LML = {float(post.lml):.4f}")
    print(f"mean |mu* - f| = {float(jnp.mean(jnp.abs(post.mean - jnp.asarray(true_fn(x_test))))):.4f}")
    print(f"artifacts in {args.out}/")


if __name__ == "__main__":
    main()
