"""Nyström preconditioner for large-n kernel CG solves.

Plain Jacobi-preconditioned CG stalls on dense RBF systems at n ~ 100k:
the kernel's top eigenvalue grows O(n) while the noise floor stays at
s = 1e-2, so kappa ~ 1e5-1e6 and the residual barely moves (||r|| 241 ->
192 after 100 iterations at n = 102400). The standard fix
("Preconditioning Kernel Matrices", PAPERS.md) is a low-rank spectral
preconditioner built from the Nyström projection of K onto r landmarks:

    K  ~=  U U^T = Q diag(lam) Q^T,   U = K_nm L_mm^{-T},  K_mm = L_mm L_mm^T
    P   =  Q diag(lam + s) Q^T + (lam_min + s) (I - Q Q^T)
    P^{-1} v = v / (lam_min + s) + Q [1/(lam + s) - 1/(lam_min + s)] Q^T v

with Q (n x r) orthonormal, from a Householder QR of U and an
eigendecomposition of the small R R^T. This is the form of Frangella,
Tropp & Udell, "Randomized Nyström preconditioning" (SIAM J. Matrix
Anal. Appl., 2023): the complement of Q's range is scaled to the smallest
retained eigenvalue instead of s.

Why not the textbook Woodbury apply (v - U (s I + U^T U)^{-1} U^T v) / s:
in f32 it subtracts two vectors that agree to lam_max / s ~ 4e5, after an
r x r solve whose error is kappa(s I + U^T U) * eps. At n = 102400 on an
H100 that apply reproduced P^{-1} to no digit and CG never converged
(120 iterations, residual above the right-hand side); with orthonormal Q
the same problem converges in 17 iterations (PERF.md).

Setup is O(n r^2 + r^3) FLOPs and O(n r) memory — small next to the
kernel matvecs of one solve — and each application is two (n x r) GEMMs.

No reference equivalent (the reference never solves beyond dense Cholesky,
[ref: GP_regression.py:138]); this powers the framework's n = 100k path
(BASELINE.md row 2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_process_tpu.linalg import cholesky as _chol
from gaussian_process_tpu.ops import kernels as _k


class NystromPreconditioner(NamedTuple):
    Q: jnp.ndarray  # (n, r) orthonormal eigenvectors of U U^T
    lam: jnp.ndarray  # (r,) its eigenvalues, ascending
    shift: jnp.ndarray  # scalar s
    landmarks: jnp.ndarray  # (r,) landmark indices into x

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        """P^{-1} v; v is (n,) or (n, k)."""
        return eig_apply(self.Q, self.lam, self.shift, v)


def eig_basis(U: jnp.ndarray):
    """(Q, lam) with U U^T = Q diag(lam) Q^T, Q orthonormal (Householder
    QR of U, then eigh of the small R R^T); lam ascending, clipped at 0."""
    Q, R = jnp.linalg.qr(U)
    lam, Z = jnp.linalg.eigh(
        jnp.dot(R, R.T, preferred_element_type=R.dtype, precision=lax.Precision.HIGHEST)
    )
    Q = jnp.dot(Q, Z, preferred_element_type=Q.dtype, precision=lax.Precision.HIGHEST)
    return Q, jnp.maximum(lam, 0.0)


def eig_apply(Q, lam, shift, v, *, reduce=None):
    """P^{-1} v for P = Q diag(lam + s) Q^T + (lam_min + s)(I - Q Q^T).

    ``reduce`` sums the (r, k) projection across devices when Q and v are
    row-sharded (parallel/cg.py passes a psum)."""
    vec = v.ndim == 1
    vv = v[:, None] if vec else v
    floor = lam[0] + shift
    coef = 1.0 / (lam + shift) - 1.0 / floor
    w = jnp.dot(Q.T, vv, preferred_element_type=vv.dtype,
                precision=lax.Precision.HIGHEST)
    if reduce is not None:
        w = reduce(w)
    out = vv / floor + jnp.dot(
        Q, coef[:, None].astype(vv.dtype) * w, preferred_element_type=vv.dtype,
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0] if vec else out


def make_nystrom_preconditioner(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    *,
    shift,
    rank: int = 512,
    key: Optional[jax.Array] = None,
    jitter: float = 1e-6,
    row_chunk: Optional[int] = None,
) -> NystromPreconditioner:
    """Build the rank-``rank`` Nyström preconditioner for K(x, x) + shift I.

    ``kernel``/``params`` must be the white-free kernel (the caller folds
    White variance into ``shift``, as the CG solvers already do).
    Landmarks are a uniform random subset (``key=None`` -> evenly strided
    subset, deterministic).

    ``row_chunk``: build U in ``lax.map`` row blocks of this size. The
    dense build holds K_nm, its transpose, the TRSM result AND U
    simultaneously (4x n*r floats: 6.7 GB for rank 2048 at n = 204800,
    where U itself is 1.7 GB); the chunked build's workspace is O(row_chunk * rank) beside
    the U output, at the cost of applying an explicit L_mm^{-T} as a GEMM
    per chunk (preconditioner-quality arithmetic — CG corrects any
    rounding). "auto"/None: chunk at 65536 rows when n * r would exceed
    ~2^28 floats, else the dense build.
    """
    U, idx = make_nystrom_factor(
        kernel, params, x, rank=rank, key=key, jitter=jitter,
        row_chunk=row_chunk,
    )
    Q, lam = eig_basis(U)
    return NystromPreconditioner(
        Q=Q, lam=lam, shift=jnp.asarray(shift, U.dtype), landmarks=idx,
    )


def make_nystrom_factor(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    *,
    rank: int = 512,
    key: Optional[jax.Array] = None,
    jitter: float = 1e-6,
    row_chunk: Optional[int] = None,
):
    """The bare rank-``rank`` Nyström factor of K(x, x): returns
    ``(U, landmarks)`` with K ~= U U^T.

    Shared by :func:`make_nystrom_preconditioner` (which orthonormalises
    it) and consumers that re-weight U per outer iteration — the Laplace
    classifier preconditions B = I + sW K sW with I + (sW U)(sW U)^T,
    rebuilding only the (r, r) Gram each Newton step while U is computed
    once (gp/classification.py, r5).
    """
    x = _k._dist._as_2d(x)
    n = x.shape[0]
    r = min(rank, n)
    if key is None:
        idx = (jnp.arange(r) * (n // r)).astype(jnp.int32)
    else:
        idx = jax.random.choice(key, n, shape=(r,), replace=False)
    z = x[idx]

    K_mm = _k.gram(kernel, params, z)
    # relative jitter keeps chol(K_mm) sane when landmarks nearly coincide
    res = _chol.safe_cholesky(K_mm, initial_jitter=jitter)

    if row_chunk is None and n * r > (1 << 28):
        row_chunk = 65536
    if row_chunk is not None and n > row_chunk:
        c = int(row_chunk)
        n_pad = -(-n // c) * c
        x_pad = jnp.pad(x, ((0, n_pad - n), (0, 0)))
        valid = (jnp.arange(n_pad) < n).reshape(n_pad // c, c)
        xb = x_pad.reshape(n_pad // c, c, x.shape[1])
        Wt = lax.linalg.triangular_solve(
            res.factor, jnp.eye(r, dtype=x.dtype), left_side=True, lower=True
        ).T  # L_mm^{-T} (r, r)

        def block(inp):
            x_c, m_c = inp
            Kc = _k.gram(kernel, params, x_c, z)  # (c, r)
            Uc = jnp.dot(
                Kc, Wt, preferred_element_type=x.dtype,
                precision=lax.Precision.HIGHEST,
            )
            return jnp.where(m_c[:, None], Uc, 0.0)

        U = lax.map(block, (xb, valid)).reshape(n_pad, r)[:n]
    else:
        K_nm = _k.gram(kernel, params, x, z)  # (n, r)
        # U = K_nm L_mm^{-T}  <=>  U^T = L_mm^{-1} K_nm^T
        Ut = lax.linalg.triangular_solve(
            res.factor, K_nm.T, left_side=True, lower=True
        )
        U = Ut.T
    return U, idx
