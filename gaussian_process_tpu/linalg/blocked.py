"""Left-looking blocked Cholesky with FP32 update GEMMs.

Used by ``cholesky.safe_cholesky`` for n >= ``MIN_BLOCKED_N``. On an H100
at n=8192 (f32 RBF kernel + 5e-4 noise, the bench ``solve`` data) it
factors in 10.6 ms against 8.6 ms for cuSOLVER's ``potrf``
(``lax.linalg.cholesky``), but its log-determinant is 3x more accurate
(relative error 1.2e-5 against 4.1e-5 vs float64): with the stock factor
the posterior's LML misses the 3e-4 parity gate (4.3e-4), with this one
it holds it (1.3e-5). PERF.md has the measurement.

The algorithm (see ``blocked_cholesky``): exact lower-triangle FLOPs
(n^3/6 MACs), ~4 ops per panel with growing GEMM inner dimensions, and a
small XLA graph. The update GEMMs run at ``Precision.HIGHEST`` (true FP32
on a GPU; a bare f32 dot may run in TF32, which loses digits through
Schur-complement cancellation).

The panel loop is unrolled in Python (shapes shrink per panel, all
static), which XLA compiles into one program; panel counts are
n/block <= ~32, so compile time stays modest. Everything is pure
jax.numpy — jit/vmap/grad compose as usual (for the LML path the
custom-VJP in ``cholesky.safe_cholesky`` bypasses this anyway).

No reference equivalent: the reference calls ``np.linalg.cholesky`` on the
host [ref: GP_regression.py:138] and never blocks anything.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

DEFAULT_BLOCK = 1024
# below this size the stock factorization is used
MIN_BLOCKED_N = 4096


def blocked_cholesky(
    K: jnp.ndarray,
    *,
    block: int = DEFAULT_BLOCK,
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Lower Cholesky factor of PSD ``K`` via LEFT-looking tiled
    factorization. Semantically identical to ``lax.linalg.cholesky`` (NaN
    on indefinite input).

    Each panel k gathers ALL its updates at once from the already-computed
    factor columns L[:, :kb]:

        A_kk' = K_kk - L_k: L_k:^T          (one small SYRK, inner dim kb)
        L_kk  = chol(A_kk')                 (stock)
        A_col = K_col - L_below L_k:^T      (ONE GEMM, inner dim kb)
        L_col = A_col L_kk^{-T}             (TRSM)

    Why left-looking and not the textbook right-looking trailing update:
    FLOPs are the exact lower-triangle count (a square trailing SYRK
    computes both halves of a symmetric update — 2x waste), the graph
    needs ~4 ops per panel (a triangle-aware right-looking update needs
    O(p^2) slices), and the per-panel GEMMs have growing inner dimension
    kb instead of fixed narrow k=b updates.

    ``precision`` sets the update GEMMs' precision. HIGHEST (default) is
    what the parity gate requires; lower settings lose ~3 digits on the
    factor through Schur-complement cancellation.

    NaN semantics match stock cholesky: an indefinite leading block NaNs
    its panel, and the NaN propagates into every later panel through the
    update GEMMs, so ``cholesky.safe_cholesky``'s diagonal check sees it.
    """
    n = K.shape[-1]
    if K.ndim != 2:
        raise ValueError("blocked_cholesky expects a single (n, n) matrix")
    if n <= max(block, MIN_BLOCKED_N):
        return lax.linalg.cholesky(K)
    dtype = K.dtype
    L = jnp.zeros_like(K)
    off = 0
    while off < n:
        b = min(block, n - off)
        A_kk = lax.dynamic_slice(K, (off, off), (b, b))
        if off > 0:
            Lrow = lax.dynamic_slice(L, (off, 0), (b, off))
            A_kk = A_kk - jnp.dot(
                Lrow, Lrow.T, preferred_element_type=dtype, precision=precision
            )
        rem = n - off - b
        L_kk = lax.linalg.cholesky(A_kk)
        if rem > 0:
            A_col = lax.dynamic_slice(K, (off + b, off), (rem, b))
            if off > 0:
                Lbot = lax.dynamic_slice(L, (off + b, 0), (rem, off))
                A_col = A_col - jnp.dot(
                    Lbot, Lrow.T, preferred_element_type=dtype,
                    precision=precision,
                )
            L_col = lax.linalg.triangular_solve(
                L_kk, A_col, left_side=False, lower=True, transpose_a=True
            )
            panel = jnp.concatenate([L_kk, L_col], axis=0)
        else:
            panel = L_kk
        L = lax.dynamic_update_slice(L, panel, (off, off))
        off += b
    return L
