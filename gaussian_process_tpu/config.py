"""Frozen configuration dataclasses.

The reference keeps every knob as an inline magic number (SURVEY.md Q6):
observation noise 5e-4 [ref: GP_regression.py:120, tune_hyperparms_regression.py:115,302,
CO2_example.py:139], BO-surrogate noise 1e-4 [ref: tune_hyperparms_regression.py:75,
CO2_example.py:160], posterior-sampling jitter 1e-6 [ref: GP_regression.py:154],
Newton tolerances 1e-4 / 1e-2 [ref: GP_binary_classification.py:98,
GP_multi_classification.py:138], gradient-ascent tol 1e-3 and lr 0.01
[ref: tune_hyperparms_regression.py:117,63].

Here every constant is a named field with the reference value as default, so the
parity suite can instantiate reference-faithful configs while production code
overrides freely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Linear-algebra behaviour for GP solves."""

    noise_variance: float = 5e-4  # observation noise s [ref: GP_regression.py:120]
    sampling_jitter: float = 1e-6  # posterior-sample jitter [ref: GP_regression.py:154]
    max_chol_attempts: int = 8  # jitter-escalation retries on non-PSD K
    jitter_growth: float = 10.0
    # Conjugate-gradient settings (large-n path; no reference equivalent —
    # the reference always factorizes densely, e.g. GP_regression.py:138).
    cg_tol: float = 1e-6
    cg_max_iters: int = 1000
    cg_precondition: bool = True


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Laplace-approximation Newton iteration.

    The reference caps iterations at 10000 with tol 1e-4 (binary)
    [ref: GP_binary_classification.py:98,114] and tol 1e-2 with damping 1e-4
    (multi-class trainer2) [ref: GP_multi_classification.py:138-141].
    We implement true Newton (W and grad recomputed at the current iterate —
    fixing reference quirk Q2) so far fewer iterations are needed.
    """

    tol: float = 1e-6
    max_iters: int = 100
    # multi-class damped-gradient fallback settings (reference trainer2)
    damping: float = 0.0


@dataclasses.dataclass(frozen=True)
class GradientAscentConfig:
    """LML gradient-based hyperparameter optimisation.

    Replaces the hand-derived RBF lengthscale gradient
    [ref: tune_hyperparms_regression.py:31-64] with jax.grad through the LML.
    """

    learning_rate: float = 0.01  # [ref: tune_hyperparms_regression.py:63]
    tol: float = 1e-3  # ΔLML stop criterion [ref: tune_hyperparms_regression.py:117]
    max_iters: int = 10000  # [ref: tune_hyperparms_regression.py:121]
    optimizer: str = "sgd"  # "sgd" reproduces reference ascent; "adam" for production


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """Bayesian-optimisation hyperparameter search.

    [ref: tune_hyperparms_regression.py:349-395 (1-D, n_iterations=3),
    CO2_example.py:330-379 (11-D, 10 iters x 500 candidates)]
    """

    n_iterations: int = 3
    n_candidates: int = 100
    surrogate_noise: float = 1e-4  # [ref: tune_hyperparms_regression.py:75]
    acquisition: str = "PI"  # "PI" | "EI" | "UCB" | "TS"
    ucb_kappa: float = 0.001  # [ref: tune_hyperparms_regression.py:219]
    pi_early_stop: float = 1e-3  # PI stops when max CDF <= this [ref: :183-188]
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution.

    No reference equivalent (the reference is single-process NumPy; SURVEY.md
    C13-C16). Axes: ``data`` shards kernel-matrix block-rows over chips;
    ``restart`` shards independent hyperparameter restarts.
    """

    data_axis: str = "data"
    restart_axis: str = "restart"
    data_axis_size: Optional[int] = None  # None -> all devices on the data axis
    restart_axis_size: int = 1


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    n: int = 8192
    d: int = 8
    dtype: str = "float32"
    warmup: int = 2
    iters: int = 5


DEFAULT_SOLVE = SolveConfig()
DEFAULT_NEWTON = NewtonConfig()
DEFAULT_GA = GradientAscentConfig()
DEFAULT_BO = BOConfig()
DEFAULT_MESH = MeshConfig()
