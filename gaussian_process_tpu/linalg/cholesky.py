"""Cholesky factorization and triangular solves with NaN-guarded jitter.

The reference factorizes densely everywhere (``np.linalg.cholesky``
[ref: GP_regression.py:138]) and — wastefully — inverts triangular factors
(``np.linalg.inv(L)`` [ref: GP_binary_classification.py:108,
CO2_example.py:144,169,199]). Here every solve goes through
``jax.lax.linalg.triangular_solve`` (cuBLAS TRSM on a GPU), and a non-PSD factorization is detected *inside the compiled program*
(NaN on the factor diagonal) and retried with escalating jitter via
``lax.while_loop`` — no host round-trip, jit/vmap/grad-safe.

Jitter escalation generalizes the reference's fixed constants
(s = 5e-4 observation noise, 1e-6 sampling jitter; SURVEY.md Q6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_process_tpu.linalg import blocked as _blocked


def _chol_dispatch(K: jnp.ndarray) -> jnp.ndarray:
    """Stock Cholesky below MIN_BLOCKED_N; the left-looking blocked one,
    whose FP32 update GEMMs give a more accurate factor than cuSOLVER's
    f32 potrf, above it (see linalg/blocked.py). Semantics identical (NaN
    on indefinite input), so the jitter-retry and custom_vjp logic below
    are algorithm-agnostic."""
    if K.ndim == 2 and K.shape[-1] >= _blocked.MIN_BLOCKED_N:
        return _blocked.blocked_cholesky(K)
    return lax.linalg.cholesky(K)


class CholeskyResult(NamedTuple):
    factor: jnp.ndarray  # lower-triangular L with K + jitter*I = L L^T
    jitter: jnp.ndarray  # scalar jitter actually applied (0 if none needed)
    ok: jnp.ndarray  # scalar bool: factorization succeeded


def _chol_ok(L: jnp.ndarray) -> jnp.ndarray:
    # XLA's cholesky writes NaN rows on indefinite input; the diagonal is the
    # cheapest sufficient check (SURVEY.md sec. 5 "race detection" row: NaN on
    # the factor diagonal is the real GP failure mode).
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    return jnp.all(jnp.isfinite(d) & (d > 0))


def _safe_chol_impl(K0, min_retry: float, growth: float, max_attempts: int):
    """One factorization on the happy path; escalating-jitter retries run
    only when the first diagonal comes back NaN/non-positive. Primal-only —
    gradients are supplied by the custom_vjp below, so the retry while_loop
    never needs to be differentiated."""
    n = K0.shape[-1]
    eye = jnp.eye(n, dtype=K0.dtype)
    scale = jnp.mean(jnp.abs(jnp.diagonal(K0, axis1=-2, axis2=-1))) + jnp.asarray(
        1.0, K0.dtype
    )

    def cond(state):
        attempt, L, _ = state
        return (~_chol_ok(L)) & (attempt < max_attempts)

    def body(state):
        attempt, _, _ = state
        jit_val = (
            jnp.asarray(min_retry, K0.dtype)
            * scale
            * (jnp.asarray(growth, K0.dtype) ** attempt.astype(K0.dtype))
        )
        L = _chol_dispatch(K0 + jit_val * eye)
        return attempt + 1, L, jit_val

    L0 = _chol_dispatch(K0)
    zero = jnp.asarray(0.0, K0.dtype)
    _, L, jitter = lax.while_loop(cond, body, (jnp.asarray(0), L0, zero))
    return L, jitter, _chol_ok(L)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _safe_chol(K0, min_retry: float, growth: float, max_attempts: int):
    return _safe_chol_impl(K0, min_retry, growth, max_attempts)


def _safe_chol_fwd(K0, min_retry, growth, max_attempts):
    out = _safe_chol_impl(K0, min_retry, growth, max_attempts)
    _, jitter, ok = out
    return out, (K0, jitter, ok)


def _safe_chol_bwd(min_retry, growth, max_attempts, res, cts):
    # Pullback of L = chol(K0 + jitter I) with the *selected* jitter held
    # constant (it is piecewise-constant in K0, so its a.e.-gradient is 0 —
    # the same semantics the old stop_gradient formulation had). Recomputing
    # the factorization here keeps the primal path at exactly one Cholesky;
    # grad callers pay the same two they always did. If even the escalated
    # jitter failed (ok=False), the factor is NaN and no finite gradient
    # exists — substitute I / zero-grads so the NaN cannot poison unrelated
    # batch elements under vmap.
    ct_L = cts[0]
    K0, jitter, ok = res
    eye = jnp.eye(K0.shape[-1], dtype=K0.dtype)
    okb = ok[..., None, None]
    jitb = jitter[..., None, None]
    K_safe = jnp.where(okb, K0, eye)
    _, vjp = jax.vjp(lambda K: lax.linalg.cholesky(K + jitb * eye), K_safe)
    (K_bar,) = vjp(ct_L)
    return (jnp.where(okb, K_bar, jnp.zeros_like(K_bar)),)


_safe_chol.defvjp(_safe_chol_fwd, _safe_chol_bwd)


def safe_cholesky(
    K: jnp.ndarray,
    *,
    initial_jitter: float = 0.0,
    min_retry_jitter: float = None,
    jitter_growth: float = 10.0,
    max_attempts: int = 8,
) -> CholeskyResult:
    """Cholesky of K (+ escalating jitter*I on failure), jit- AND grad-safe.

    ``initial_jitter`` is added unconditionally (use it for the reference's
    noise term s*I [ref: GP_regression.py:138]); retries start near machine
    epsilon for K's dtype, scaled by mean diagonal magnitude (float32 needs
    ~1e4x more jitter than the reference's float64 constants assume).

    Cost: exactly ONE factorization when K + initial_jitter*I is already PSD
    (the overwhelmingly common case; the older probe-then-refactorize
    formulation paid two). The
    retry search lives inside a custom_vjp primal, so reverse-mode AD never
    sees the while_loop; the pullback treats the selected jitter as constant
    (it is piecewise-constant in K).
    """
    n = K.shape[-1]
    if min_retry_jitter is None:
        min_retry_jitter = 10.0 * float(jnp.finfo(K.dtype).eps)

    K0 = K + jnp.asarray(initial_jitter, K.dtype) * jnp.eye(n, dtype=K.dtype)
    L, jitter, ok = _safe_chol(
        K0, float(min_retry_jitter), float(jitter_growth), int(max_attempts)
    )
    return CholeskyResult(
        factor=L,
        jitter=jitter + jnp.asarray(initial_jitter, K.dtype),
        ok=ok,
    )


def tri_solve(L: jnp.ndarray, b: jnp.ndarray, *, lower: bool = True, trans: bool = False) -> jnp.ndarray:
    """Solve L x = b (or L^T x = b with ``trans``) for lower-triangular L.

    Replaces the reference's ``np.linalg.solve(L, ...)`` pairs
    [ref: GP_regression.py:139-140] and its explicit ``np.linalg.inv(L)``
    [ref: GP_binary_classification.py:108] with blocked TRSM.
    """
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    x = lax.linalg.triangular_solve(
        L,
        b,
        left_side=True,
        lower=lower,
        transpose_a=trans,
    )
    return x[..., 0] if vec else x


def cholesky_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b — the alpha = L^T \\ (L \\ y) pattern of
    R&W Alg. 2.1 [ref: GP_regression.py:139-140]."""
    return tri_solve(L, tri_solve(L, b), trans=True)


def logdet_from_chol(L: jnp.ndarray) -> jnp.ndarray:
    """log |K| = 2 * sum(log diag L) — the corrected LML logdet term
    [ref: tune_hyperparms_regression.py:141; the inline variant at
    GP_regression.py:151 omits the log (reference quirk Q1)]."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def add_diagonal(K: jnp.ndarray, value) -> jnp.ndarray:
    """K + value * I without materialising an identity matrix."""
    n = K.shape[-1]
    idx = jnp.arange(n)
    return K.at[..., idx, idx].add(value)
