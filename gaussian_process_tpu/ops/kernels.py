"""Covariance-function (kernel) algebra.

Pure-functional redesign of the reference's ad-hoc kernel functions:

- RBF                 [ref: GP_regression.py:8-19]
- Linear              [ref: GP_regression.py:22-33]
- Periodic            [ref: GP_regression.py:36-50]
- CO2 composite (GPML sec. 5.4.3): RBF + decayed-periodic + rational-quadratic
  + RBF-with-white-noise summed over 11 hyperparameters
                      [ref: CO2_example.py:9-94]

Design: a kernel is a *static* frozen dataclass (hashable, safe as a jit
closure) evaluated against a *dynamic* params pytree, so ``jax.grad`` flows
through hyperparameters and the same kernel object serves every (params, data)
combination without retracing. Combinators ``Sum``/``Product``/``Scaled``
build composites; all children of one gram evaluation share a single
pairwise-distance computation (the reference recomputes sqdist per call —
its composite shares it too [ref: CO2_example.py:76-94]).

Stationary kernels are evaluated from precomputed distance matrices, which is
what lets the fused matvec kernel (ops/pallas) reuse the same math per tile.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from gaussian_process_tpu.ops import distance as _dist

Params = Any  # pytree of jnp scalars / arrays


class _DistCache:
    """Lazily computes pairwise distances shared by all kernels in a tree."""

    def __init__(self, x1: jnp.ndarray, x2: jnp.ndarray, method: str):
        self.x1 = _dist._as_2d(x1)
        self.x2 = _dist._as_2d(x2)
        self.method = method
        self.shape = (self.x1.shape[0], self.x2.shape[0])
        self._sq: Optional[jnp.ndarray] = None
        self._l2: Optional[jnp.ndarray] = None

    @property
    def sq(self) -> jnp.ndarray:
        if self._sq is None:
            self._sq = _dist.sqdist(self.x1, self.x2, method=self.method)
        return self._sq

    @property
    def l2(self) -> jnp.ndarray:
        if self._l2 is None:
            self._l2 = jnp.sqrt(self.sq)
        return self._l2


class TileDistCache:
    """Distance 'cache' over a precomputed tile — lets the same kernel tree
    evaluate inside a Pallas tile program (ops/pallas), where sqdist is
    computed on the device per (block_row, block_col) tile. Only stationary kernels
    can be evaluated this way (Linear needs raw coordinates)."""

    def __init__(self, sq: jnp.ndarray, l2: Optional[jnp.ndarray] = None):
        self._sq = sq
        self._l2 = l2
        self.shape = sq.shape
        self.x1 = None
        self.x2 = None

    @property
    def sq(self) -> jnp.ndarray:
        return self._sq

    @property
    def l2(self) -> jnp.ndarray:
        if self._l2 is None:
            self._l2 = jnp.sqrt(self._sq)
        return self._l2


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Base class. Subclasses implement ``_eval`` and ``init_params``."""

    def init_params(self) -> Params:
        raise NotImplementedError

    def _eval(self, params: Params, cache: _DistCache, same: bool) -> jnp.ndarray:
        raise NotImplementedError

    def _eval_diag(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        """k(x_i, x_i) vector — default via zero distances."""
        raise NotImplementedError

    # Operator sugar
    def __add__(self, other: "Kernel") -> "Sum":
        return Sum(children=(self, other))

    def __mul__(self, other: "Kernel") -> "Product":
        return Product(children=(self, other))


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """Squared-exponential: sigma^2 * exp(-0.5 d^2 / l^2).

    [ref: GP_regression.py:8-19 (RBF_kernel), CO2_example.py:9-17 (kernel_1)]
    """

    def init_params(self) -> Params:
        return {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.0)}

    def _eval(self, params, cache, same):
        sig, ell = params["sigma"], params["lengthscale"]
        return (sig**2) * jnp.exp(-0.5 * cache.sq / ell**2)

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.full((n,), params["sigma"] ** 2, dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """Dot-product kernel (a - c) . (b - c), unit variance, zero mean.

    [ref: GP_regression.py:22-33 (lin_kernel)]
    """

    def init_params(self) -> Params:
        return {"offset": jnp.asarray(0.0)}

    def _eval(self, params, cache, same):
        c = params["offset"]
        a = cache.x1 - c
        b = cache.x2 - c
        # full f32: a default-precision matmul's error (TF32 on a GPU)
        # exceeds the GP jitter scale (see ops/distance.py).
        return jnp.dot(
            a, b.T, preferred_element_type=a.dtype, precision=jax.lax.Precision.HIGHEST
        )

    def _eval_diag(self, params, x):
        a = _dist._as_2d(x) - params["offset"]
        return jnp.sum(a * a, axis=-1)


@dataclasses.dataclass(frozen=True)
class Periodic(Kernel):
    """exp(-2 sin^2(pi d / p) / l^2) with unit output variance.

    [ref: GP_regression.py:36-50 (per_kernel; its lambda closes over the
    precomputed abs-distance, so the effective math is exactly this)]
    """

    def init_params(self) -> Params:
        return {"period": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.0)}

    def _eval(self, params, cache, same):
        p, ell = params["period"], params["lengthscale"]
        s = jnp.sin(jnp.pi * cache.l2 / p)
        return jnp.exp(-2.0 * s * s / ell**2)

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.ones((n,), dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class DecayedPeriodic(Kernel):
    """RBF-decayed periodic: a^2 exp(-0.5 d^2/decay^2 - 2 sin^2(pi d/p)/s^2).

    The seasonal CO2 component; the reference fixes the period at 1 year.
    [ref: CO2_example.py:20-32 (kernel_2)]
    """

    def init_params(self) -> Params:
        return {
            "amplitude": jnp.asarray(1.0),
            "decay": jnp.asarray(1.0),
            "smoothness": jnp.asarray(1.0),
            "period": jnp.asarray(1.0),
        }

    def _eval(self, params, cache, same):
        a, dec, sm = params["amplitude"], params["decay"], params["smoothness"]
        p = params.get("period", jnp.asarray(1.0))
        decay_term = -0.5 * cache.sq / dec**2
        s = jnp.sin(jnp.pi * cache.l2 / p) / sm
        return a**2 * jnp.exp(decay_term - 2.0 * s * s)

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.full((n,), params["amplitude"] ** 2, dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class RationalQuadratic(Kernel):
    """a^2 (1 + 0.5 d^2 / (alpha l^2))^(-alpha).

    [ref: CO2_example.py:35-46 (kernel_3)]
    """

    def init_params(self) -> Params:
        return {
            "amplitude": jnp.asarray(1.0),
            "lengthscale": jnp.asarray(1.0),
            "alpha": jnp.asarray(1.0),
        }

    def _eval(self, params, cache, same):
        a, ell, alpha = params["amplitude"], params["lengthscale"], params["alpha"]
        base = 1.0 + 0.5 * cache.sq / (alpha * ell**2)
        return a**2 * jnp.power(base, -alpha)

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.full((n,), params["amplitude"] ** 2, dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class Matern(Kernel):
    """Matérn covariance at nu in {1/2, 3/2, 5/2} (the closed-form orders):

        nu=1/2: sigma^2 exp(-d/l)                      (Ornstein-Uhlenbeck)
        nu=3/2: sigma^2 (1 + sqrt3 d/l) exp(-sqrt3 d/l)
        nu=5/2: sigma^2 (1 + sqrt5 d/l + 5 d^2/(3 l^2)) exp(-sqrt5 d/l)

    Beyond-reference breadth: the reference ships only RBF/linear/periodic
    plus the CO2 composite [ref: GP_regression.py:8-50, CO2_example.py:9-94];
    Matérn is the standard rough-process complement. Stationary (distance-only),
    so it runs on the fused matvec path like the others.
    """

    nu: float = 2.5  # static: selects the closed form at trace time

    def __post_init__(self):
        if self.nu not in (0.5, 1.5, 2.5):
            raise ValueError("Matern supports nu in {0.5, 1.5, 2.5}")

    def init_params(self) -> Params:
        return {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.0)}

    def _eval(self, params, cache, same):
        sig, ell = params["sigma"], params["lengthscale"]
        r = cache.l2 / ell
        if self.nu == 0.5:
            body = jnp.exp(-r)
        elif self.nu == 1.5:
            s = jnp.sqrt(3.0) * r
            body = (1.0 + s) * jnp.exp(-s)
        else:
            s = jnp.sqrt(5.0) * r
            body = (1.0 + s + s * s / 3.0) * jnp.exp(-s)
        return (sig**2) * body

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.full((n,), params["sigma"] ** 2, dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """Independent noise a^2 * delta_ij — contributes only to same-set grams.

    The reference adds its delta only when the matrix is square
    [ref: CO2_example.py:58-63 (kernel_4's eye-vs-0 switch)]; we use the
    sounder "x2 is the same set as x1" condition, which coincides on every
    path the reference exercises.
    """

    def init_params(self) -> Params:
        return {"amplitude": jnp.asarray(1.0)}

    def _eval(self, params, cache, same):
        n, m = cache.shape
        dt = jnp.result_type(cache.sq)
        if not same:
            return jnp.zeros((n, m), dtype=dt)
        return (params["amplitude"] ** 2) * jnp.eye(n, dtype=dt)

    def _eval_diag(self, params, x):
        n = jnp.shape(x)[0]
        return jnp.full((n,), params["amplitude"] ** 2, dtype=jnp.result_type(x))


@dataclasses.dataclass(frozen=True)
class Sum(Kernel):
    children: Tuple[Kernel, ...]

    def init_params(self) -> Params:
        return tuple(c.init_params() for c in self.children)

    def _eval(self, params, cache, same):
        out = self.children[0]._eval(params[0], cache, same)
        for c, p in zip(self.children[1:], params[1:]):
            out = out + c._eval(p, cache, same)
        return out

    def _eval_diag(self, params, x):
        out = self.children[0]._eval_diag(params[0], x)
        for c, p in zip(self.children[1:], params[1:]):
            out = out + c._eval_diag(p, x)
        return out


@dataclasses.dataclass(frozen=True)
class Product(Kernel):
    children: Tuple[Kernel, ...]

    def init_params(self) -> Params:
        return tuple(c.init_params() for c in self.children)

    def _eval(self, params, cache, same):
        out = self.children[0]._eval(params[0], cache, same)
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c._eval(p, cache, same)
        return out

    def _eval_diag(self, params, x):
        out = self.children[0]._eval_diag(params[0], x)
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c._eval_diag(p, x)
        return out


@dataclasses.dataclass(frozen=True)
class Scaled(Kernel):
    """amplitude^2 * base(params)."""

    base: Kernel

    def init_params(self) -> Params:
        return {"amplitude": jnp.asarray(1.0), "base": self.base.init_params()}

    def _eval(self, params, cache, same):
        return (params["amplitude"] ** 2) * self.base._eval(params["base"], cache, same)

    def _eval_diag(self, params, x):
        return (params["amplitude"] ** 2) * self.base._eval_diag(params["base"], x)


def gram(
    kernel: Kernel,
    params: Params,
    x1: jnp.ndarray,
    x2: Optional[jnp.ndarray] = None,
    *,
    method: str = "dot",
) -> jnp.ndarray:
    """Dense kernel (Gram) matrix K(x1, x2).

    When ``x2`` is None the gram is the symmetric same-set matrix and white
    noise contributes its diagonal. Distances are computed once and shared
    across the whole kernel tree.
    """
    same = x2 is None
    if same:
        x2 = x1
    cache = _DistCache(x1, x2, method)
    return kernel._eval(params, cache, same)


def gram_diag(kernel: Kernel, params: Params, x: jnp.ndarray) -> jnp.ndarray:
    """diag(K(x, x)) without materialising the matrix — the variance path
    only needs diag(K_ss) [ref: GP_regression.py:147]."""
    return kernel._eval_diag(params, x)


def co2_kernel(*, noise_delta_everywhere: bool = False) -> Sum:
    """The Mauna Loa composite kernel of GPML sec. 5.4.3.

    k(theta) = RBF(t1,t2) + DecayedPeriodic(t3,t4,t5) + RQ(t6,t7,t8)
               + RBF(t9,t10) + White(t11)
    [ref: CO2_example.py:69-94 (covariance_function)]
    """
    del noise_delta_everywhere
    return Sum(
        children=(
            RBF(),
            DecayedPeriodic(),
            RationalQuadratic(),
            RBF(),
            White(),
        )
    )


def co2_params_from_vector(theta: jnp.ndarray) -> Params:
    """Map the reference's flat 11-vector [theta_1..theta_11]
    [ref: CO2_example.py:109-128, book values at :324] onto the composite's
    params pytree."""
    theta = jnp.asarray(theta)
    return (
        {"sigma": theta[0], "lengthscale": theta[1]},
        {
            "amplitude": theta[2],
            "decay": theta[3],
            "smoothness": theta[4],
            "period": jnp.asarray(1.0, dtype=theta.dtype),
        },
        {"amplitude": theta[5], "lengthscale": theta[6], "alpha": theta[7]},
        {"sigma": theta[8], "lengthscale": theta[9]},
        {"amplitude": theta[10]},
    )


def co2_vector_from_params(params: Params) -> jnp.ndarray:
    """Inverse of :func:`co2_params_from_vector`."""
    return jnp.stack(
        [
            params[0]["sigma"],
            params[0]["lengthscale"],
            params[1]["amplitude"],
            params[1]["decay"],
            params[1]["smoothness"],
            params[2]["amplitude"],
            params[2]["lengthscale"],
            params[2]["alpha"],
            params[3]["sigma"],
            params[3]["lengthscale"],
            params[4]["amplitude"],
        ]
    )


def is_stationary(kernel: Kernel) -> bool:
    """True if every leaf depends on inputs only through pairwise distances
    (evaluable from a TileDistCache)."""
    if isinstance(kernel, (Sum, Product)):
        return all(is_stationary(c) for c in kernel.children)
    if isinstance(kernel, Scaled):
        return is_stationary(kernel.base)
    return isinstance(
        kernel, (RBF, Matern, Periodic, DecayedPeriodic, RationalQuadratic, White)
    )


def needs_l2(kernel: Kernel) -> bool:
    """True if any leaf reads the l2 (not squared) distance."""
    if isinstance(kernel, (Sum, Product)):
        return any(needs_l2(c) for c in kernel.children)
    if isinstance(kernel, Scaled):
        return needs_l2(kernel.base)
    return isinstance(kernel, (Matern, Periodic, DecayedPeriodic))


def split_white(kernel: Kernel, params: Params):
    """Split top-level White terms out of a Sum: returns
    (kernel_without_white, params_without_white, white_variance_or_None).

    The matrix-free matvec adds the white diagonal as ``white * v``
    instead of evaluating an identity per tile.
    """
    if isinstance(kernel, White):
        return None, None, params["amplitude"] ** 2
    if isinstance(kernel, Sum):
        keep_k, keep_p, white = [], [], None
        for c, p in zip(kernel.children, params):
            if isinstance(c, White):
                w = p["amplitude"] ** 2
                white = w if white is None else white + w
            else:
                keep_k.append(c)
                keep_p.append(p)
        if white is None:
            return kernel, params, None
        if not keep_k:
            return None, None, white
        if len(keep_k) == 1:
            return keep_k[0], keep_p[0], white
        return Sum(children=tuple(keep_k)), tuple(keep_p), white
    return kernel, params, None


def eval_from_distances(
    kernel: Kernel, params: Params, sq: jnp.ndarray, l2: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Evaluate a stationary kernel tree on precomputed distance tiles
    (same=False semantics: White contributes zero — callers add the white
    diagonal themselves)."""
    return kernel._eval(params, TileDistCache(sq, l2), same=False)


def tree_map_params(fn, params: Params) -> Params:
    """Apply ``fn`` to every leaf of a params pytree (e.g. log/exp transforms
    for positivity-constrained optimisation)."""
    return jax.tree_util.tree_map(fn, params)
