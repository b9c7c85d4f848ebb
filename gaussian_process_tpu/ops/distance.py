"""Pairwise-distance primitives.

The reference computes squared distances with a broadcast subtraction,
``((a[:, :, None] - b[:, :, None].T) ** 2).sum(1)`` [ref: GP_regression.py:18,
CO2_example.py:76-87] — an O(n*m*d) VPU-only pattern that materialises an
(n, d, m) intermediate. Here we instead use the expansion

    ||a_i - b_j||^2 = ||a_i||^2 + ||b_j||^2 - 2 a_i . b_j

so the dominant term is a single (n, d) x (d, m) matmul
and XLA fuses the rank-1 norm corrections into the same loop. For tiny d and
strict accuracy requirements (float32 cancellation), ``method="diff"`` keeps
the broadcast form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _as_2d(x: jnp.ndarray) -> jnp.ndarray:
    """Promote (n,) -> (n, 1) so 1-D inputs work like the reference's (n, 1)."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    return x


def sqdist(a: jnp.ndarray, b: jnp.ndarray, *, method: str = "dot") -> jnp.ndarray:
    """Pairwise squared Euclidean distance matrix, shape (n, m).

    method="dot": matmul-friendly ||a||^2 + ||b||^2 - 2ab^T (clamped at 0).
    method="diff": broadcast subtraction (reference-faithful, more accurate
    at low precision; O(n*m*d) VPU work).
    """
    a = _as_2d(a)
    b = _as_2d(b)
    if method == "diff":
        d = a[:, None, :] - b[None, :, :]
        return jnp.sum(d * d, axis=-1)
    # Shift both sets by a common center before expanding: sqdist is
    # shift-invariant, but the expansion's cancellation error scales with
    # ||x||^2 — uncentered year-valued inputs (x ~ 2000, CO2 workload) lose
    # ~eps * 4e6 absolute accuracy in float32, which destroys short-lengthscale
    # kernels. Centering makes the error scale with the data *spread* instead.
    center = jax.lax.stop_gradient(jnp.mean(a, axis=0, keepdims=True))
    a = a - center
    b = b - center
    a2 = jnp.sum(a * a, axis=-1)[:, None]
    b2 = jnp.sum(b * b, axis=-1)[None, :]
    # precision=HIGHEST: a default-precision f32 matmul may run in reduced
    # precision (TF32 on a GPU, ~1e-3 relative), an error in the cross
    # term larger than the GP noise jitter (5e-4) that corrupts K
    # outright. The d-contraction is O(n*m*d) flops — negligible next to
    # the O(n^3) factorization — so full f32 costs nothing here.
    cross = jnp.dot(
        a, b.T, preferred_element_type=a.dtype, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.maximum(a2 + b2 - 2.0 * cross, 0.0)


def absdist(a: jnp.ndarray, b: jnp.ndarray, *, method: str = "dot") -> jnp.ndarray:
    """Pairwise Euclidean (l2) distance matrix, shape (n, m).

    The reference's periodic kernel uses |a - b| built via np.tile
    [ref: GP_regression.py:48]; for d=1 that equals the l2 norm, which is what
    the CO2 composite uses too [ref: CO2_example.py:77,87].
    """
    if method == "diff":
        a = _as_2d(a)
        b = _as_2d(b)
        if a.shape[-1] == 1:
            return jnp.abs(a - b.T)
    return jnp.sqrt(sqdist(a, b, method=method))
