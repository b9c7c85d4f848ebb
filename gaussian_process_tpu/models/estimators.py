"""Estimator classes: GPRegressor, GPBinaryClassifier, GPMulticlassClassifier.

Object-level wrappers over the functional core — the migration target for the
reference's script workflows:

- ``GPRegressor``      <- GP_regression.py's prediction pipeline
                          [ref: GP_regression.py:109-156] + hyperparameter
                          tuning [ref: tune_hyperparms_regression.py:398-432]
- ``GPBinaryClassifier``    <- GP_binary_classification.py's train/predict
                          [ref: GP_binary_classification.py:86-154]
- ``GPMulticlassClassifier`` <- GP_multi_classification.py's train/predict
                          [ref: GP_multi_classification.py:129-197]

Design: ``fit`` stores only arrays (jnp pytrees) on ``self``; every compute
path delegates to the pure functions in ``gp``/``opt`` so XLA compiles one
program per shape and the classes add zero per-call Python overhead beyond
attribute reads.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gaussian_process_tpu import gp
from gaussian_process_tpu.gp import classification as _cls
from gaussian_process_tpu.gp import multiclass as _mc
from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.opt import gradient as _grad


class GPRegressor:
    """Exact GP regression (R&W Alg. 2.1) with optional LML hyperparameter
    optimisation via jax.grad.

    >>> model = GPRegressor(ops.RBF(), noise_variance=5e-4)
    >>> model.fit(x_train, y_train, optimize=True)
    >>> mean, std = model.predict(x_test, return_std=True)
    """

    def __init__(
        self,
        kernel: _k.Kernel,
        params: Optional[_k.Params] = None,
        *,
        noise_variance: float = 5e-4,
        dist_method: str = "dot",
    ):
        self.kernel = kernel
        self.params = kernel.init_params() if params is None else params
        self.noise_variance = float(noise_variance)
        self.dist_method = dist_method
        self.x_train = None
        self.y_train = None
        self.lml_ = None

    def fit(
        self,
        x: jnp.ndarray,
        y: jnp.ndarray,
        *,
        optimize: bool = False,
        learning_rate: float = 0.01,
        max_iters: int = 1000,
        optimizer: str = "adam",
        transform: str = "log",
        trainable=None,
    ) -> "GPRegressor":
        """Store the training set; optionally maximise the LML over the
        kernel hyperparameters (replaces the reference's hand-derived
        gradient loop [ref: tune_hyperparms_regression.py:31-64,104-162])."""
        self.x_train = jnp.asarray(x)
        self.y_train = jnp.asarray(y)
        if optimize:
            res = _grad.tune_gradient_ascent(
                self.kernel,
                self.params,
                self.x_train,
                self.y_train,
                noise_variance=self.noise_variance,
                learning_rate=learning_rate,
                max_iters=max_iters,
                optimizer=optimizer,
                transform=transform,
                trainable=trainable,
                dist_method=self.dist_method,
            )
            self.params = res.params
            self.lml_ = res.lml
        else:
            self.lml_ = gp.log_marginal_likelihood(
                self.kernel,
                self.params,
                self.x_train,
                self.y_train,
                noise_variance=self.noise_variance,
                dist_method=self.dist_method,
            )
        return self

    def _check_fitted(self):
        if self.x_train is None:
            raise RuntimeError("call fit() first")

    def posterior(self, x_test: jnp.ndarray) -> gp.Posterior:
        self._check_fitted()
        return gp.posterior(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            jnp.asarray(x_test),
            noise_variance=self.noise_variance,
            dist_method=self.dist_method,
        )

    def posterior_whitened(
        self, x_test: jnp.ndarray, *, dtype=jnp.float32
    ) -> gp.WhitenedPosterior:
        """f32-safe whitened posterior (``gp.whitened_posterior``): inputs
        centered, targets standardised via an exact Scaled-kernel
        reparameterisation — the f32 path for ill-conditioned data (e.g.
        year-valued CO2 inputs with book-scale amplitudes, where the raw
        f32 dot-trick sqdist and 1e4-magnitude kernel entries break).
        Stationary kernels only; accuracy contract in
        tests/test_whitened.py."""
        self._check_fitted()
        return gp.whitened_posterior(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            jnp.asarray(x_test),
            noise_variance=self.noise_variance,
            dtype=dtype,
        )

    def posterior_cg(self, x_test: jnp.ndarray, **kwargs) -> gp.CGPosterior:
        # Matrix-free posterior (mean + variance): the large-n path where K
        # cannot be materialised (Pallas tile matvec + Nystrom-preconditioned
        # block CG). See gp.posterior_cg for knobs.
        self._check_fitted()
        return gp.posterior_cg(
            self.kernel,
            self.params,
            self.x_train,
            self.y_train,
            jnp.asarray(x_test),
            noise_variance=self.noise_variance,
            **kwargs,
        )

    def predict(
        self, x_test: jnp.ndarray, *, return_std: bool = False,
        solver: str = "auto",
    ):
        # solver: "cholesky" (exact dense), "cg" (matrix-free), or "auto":
        # CG once n_train exceeds 32768, where a dense factor stops being
        # the right tool on a single chip.
        if solver == "auto":
            solver = "cg" if self.x_train.shape[0] > 32768 else "cholesky"
        if solver == "cg":
            post = self.posterior_cg(x_test)
        else:
            post = self.posterior(x_test)
        return (post.mean, post.std) if return_std else post.mean

    def sample(
        self, x_test: jnp.ndarray, key: jax.Array, *, num_functions: int = 10
    ) -> jnp.ndarray:
        """Joint posterior draws at x_test [ref: GP_regression.py:154-155]."""
        post = self.posterior(x_test)
        return gp.sample_posterior(
            self.kernel,
            self.params,
            post,
            jnp.asarray(x_test),
            key,
            num_functions=num_functions,
            dist_method=self.dist_method,
        )

    def log_marginal_likelihood(self) -> jnp.ndarray:
        self._check_fitted()
        return self.lml_


class GPBinaryClassifier:
    """Laplace-approximation binary GP classification (labels in {-1, +1}).

    True Newton at the current iterate (the reference freezes W and the
    gradient at the prior sample — quirk Q2
    [ref: GP_binary_classification.py:104-105]).
    """

    def __init__(
        self,
        kernel: _k.Kernel,
        params: Optional[_k.Params] = None,
        *,
        dist_method: str = "dot",
    ):
        self.kernel = kernel
        self.params = kernel.init_params() if params is None else params
        self.dist_method = dist_method
        self.x_train = None
        self.state = None

    def fit(
        self, x: jnp.ndarray, y: jnp.ndarray, *, tol=None,
        max_iters: int = 100, solver: str = "auto",
        precond_rank: int = 512,
    ) -> "GPBinaryClassifier":
        """``solver``: "cholesky" (dense Newton), "cg" (matrix-free Newton —
        gp.laplace_fit_cg, the n ~ 100k+ tier where the dense n x n factor
        per step cannot exist), or "auto" (cg above n = 32768)."""
        self.x_train = jnp.asarray(x)
        n = self.x_train.shape[0]
        if solver == "auto":
            solver = "cg" if n > 32768 else "cholesky"
        self._solver = solver
        if solver == "cg":
            self.state = _cls.laplace_fit_cg(
                self.kernel,
                self.params,
                self.x_train,
                jnp.asarray(y),
                tol=tol,
                max_iters=max_iters,
                precond_rank=precond_rank,
            )
        elif solver == "cholesky":
            self.state = _cls.fit_binary(
                self.kernel,
                self.params,
                self.x_train,
                jnp.asarray(y),
                tol=tol,
                max_iters=max_iters,
                dist_method=self.dist_method,
            )
        else:
            raise ValueError(f"unknown solver {solver!r}")
        return self

    def _predict_full(self, x_test) -> _cls.BinaryPrediction:
        if self.state is None:
            raise RuntimeError("call fit() first")
        if self._solver == "cg":
            return _cls.predict_binary_cg(
                self.kernel,
                self.params,
                self.state,
                self.x_train,
                jnp.asarray(x_test),
            )
        return _cls.predict_binary(
            self.kernel,
            self.params,
            self.state,
            self.x_train,
            jnp.asarray(x_test),
            dist_method=self.dist_method,
        )

    def predict(self, x_test: jnp.ndarray) -> jnp.ndarray:
        """Labels in {-1, +1} [ref: GP_binary_classification.py:35-45]."""
        return self._predict_full(x_test).label

    def predict_proba(self, x_test: jnp.ndarray, *, averaged: bool = False):
        p = self._predict_full(x_test)
        return p.prob_averaged if averaged else p.prob

    def score(self, x_test: jnp.ndarray, y_test: jnp.ndarray) -> float:
        """Classification right-rate — the reference's printed metric
        [ref: GP_binary_classification.py:241]."""
        labels = self.predict(x_test)
        return float(jnp.mean(labels == jnp.asarray(y_test)))


class GPMulticlassClassifier:
    """Laplace multi-class GP classification (R&W Alg. 3.3, block-structured:
    per-class n x n factorizations vmapped over classes — the reference's
    *disabled* trainer done right [ref: GP_multi_classification.py:66-126])."""

    def __init__(
        self,
        kernel: _k.Kernel,
        num_classes: int,
        params: Optional[_k.Params] = None,
        *,
        dist_method: str = "dot",
    ):
        self.kernel = kernel
        self.num_classes = int(num_classes)
        self.params = kernel.init_params() if params is None else params
        self.dist_method = dist_method
        self.x_train = None
        self.y_labels = None
        self.state = None

    def fit(
        self, x: jnp.ndarray, y_labels: jnp.ndarray, *, tol=None,
        max_iters: int = 100, solver: str = "auto",
        precond_rank: int = 512,
    ) -> "GPMulticlassClassifier":
        """``solver``: "cholesky" (per-class dense factorizations), "cg"
        (matrix-free stacked-system Newton — gp.laplace_fit_multiclass_cg),
        or "auto" (cg above n = 32768)."""
        self.x_train = jnp.asarray(x)
        self.y_labels = jnp.asarray(y_labels)
        n = self.x_train.shape[0]
        if solver == "auto":
            solver = "cg" if n > 32768 else "cholesky"
        self._solver = solver
        if solver == "cg":
            self.state = _mc.laplace_fit_multiclass_cg(
                self.kernel,
                self.params,
                self.x_train,
                self.y_labels,
                self.num_classes,
                tol=tol,
                max_iters=max_iters,
                precond_rank=precond_rank,
            )
        elif solver == "cholesky":
            self.state = _mc.fit_multiclass(
                self.kernel,
                self.params,
                self.x_train,
                self.y_labels,
                self.num_classes,
                tol=tol,
                max_iters=max_iters,
                dist_method=self.dist_method,
            )
        else:
            raise ValueError(f"unknown solver {solver!r}")
        return self

    def _predict_full(self, x_test) -> _mc.MulticlassPrediction:
        if self.state is None:
            raise RuntimeError("call fit() first")
        if self._solver == "cg":
            return _mc.predict_multiclass_cg(
                self.kernel,
                self.params,
                self.state,
                self.x_train,
                self.y_labels,
                jnp.asarray(x_test),
                self.num_classes,
            )
        return _mc.predict_multiclass(
            self.kernel,
            self.params,
            self.state,
            self.x_train,
            self.y_labels,
            jnp.asarray(x_test),
            self.num_classes,
            dist_method=self.dist_method,
        )

    def predict(self, x_test: jnp.ndarray) -> jnp.ndarray:
        """Integer class labels (argmax over latent class means)
        [ref: GP_multi_classification.py:179-197]."""
        return self._predict_full(x_test).label

    def predict_proba(self, x_test: jnp.ndarray) -> jnp.ndarray:
        """(num_classes, m) softmax class probabilities."""
        return self._predict_full(x_test).prob

    def score(self, x_test: jnp.ndarray, y_test: jnp.ndarray) -> float:
        """Accuracy — the reference's printed metric
        [ref: GP_multi_classification.py:253]."""
        labels = self.predict(x_test)
        return float(jnp.mean(labels == jnp.asarray(y_test)))
