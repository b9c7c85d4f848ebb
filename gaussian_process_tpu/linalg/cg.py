"""Matrix-free preconditioned conjugate gradients.

No reference equivalent — the reference always materialises and factorizes
K densely (e.g. [ref: GP_regression.py:138]), which caps n at what one
host's RAM and O(n^3) tolerate. CG + a matrix-free kernel matvec (see
ops/matvec and parallel/kernel_blocks) is the 100k-point path: K at
n = 100k in f32 is 42 GB, but K@v can be rebuilt tile by tile.

The well-conditioned setting (the reference always adds noise s = 5e-4 to
the diagonal [ref: GP_regression.py:120]) makes plain Jacobi-preconditioned
CG converge quickly (PAPERS.md: "Preconditioning Kernel Matrices",
"Conjugate Gradients for Kernel Machines").

Runs under jit: fixed-shape ``lax.while_loop`` with a residual-norm stop.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class CGState(NamedTuple):
    x: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    z: jnp.ndarray
    rz: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray


def cg_solve(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    *,
    tol: float = 1e-6,
    max_iters: int = 1000,
    precond_diag: Optional[jnp.ndarray] = None,
    precond_apply: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    x0: Optional[jnp.ndarray] = None,
    dot: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] = None,
    init_state: Optional[CGState] = None,
    max_new_iters: Optional[int] = None,
) -> CGState:
    """Solve A x = b for SPD A given only ``matvec`` (x -> A x).

    ``precond_diag``: diag(A) for Jacobi preconditioning (pass None to skip).
    ``precond_apply``: full preconditioner application r -> M^{-1} r (e.g.
    :func:`nystrom.NystromPreconditioner.apply`); overrides precond_diag.
    ``dot``: inner product — override with a psum-reducing version when x/b
    are sharded across a mesh axis (parallel/cg.py does this).
    Works on single vectors or (n, k) blocks of RHS (all columns iterate
    until the worst column converges).

    ``init_state``: resume EXACTLY from a previous :class:`CGState` (the
    search direction, preconditioned residual and rz carry over, so unlike
    an x0 restart no conjugacy — and therefore no convergence rate — is
    lost). ``max_new_iters``: cap the additional iterations this call may
    run (``iters`` still counts total). Together these make the solve
    segmentable: a host loop of bounded-latency device calls that can be
    checkpointed between segments (gp.posterior_cg_segmented).
    """
    if dot is None:
        dot = lambda u, v: jnp.sum(u * v, axis=0)

    if precond_apply is not None:
        apply_M = precond_apply
    elif precond_diag is not None:
        inv_diag = 1.0 / precond_diag
        if b.ndim > 1:
            inv_diag = inv_diag[:, None]
        apply_M = lambda r: r * inv_diag
    else:
        apply_M = lambda r: r

    bnorm = jnp.sqrt(jnp.max(dot(b, b)))
    stop = tol * jnp.maximum(bnorm, 1e-30)
    iter_cap = jnp.asarray(max_iters)
    if init_state is not None:
        init = init_state
        if max_new_iters is not None:
            iter_cap = jnp.minimum(iter_cap, init.iters + max_new_iters)
    else:
        x = jnp.zeros_like(b) if x0 is None else x0
        r = b - matvec(x) if x0 is not None else b
        z = apply_M(r)
        p = z
        rz = dot(r, z)
        init = CGState(
            x=x,
            r=r,
            p=p,
            z=z,
            rz=rz,
            iters=jnp.asarray(0),
            resnorm=jnp.sqrt(jnp.max(dot(r, r))),
        )
        if max_new_iters is not None:
            iter_cap = jnp.minimum(iter_cap, max_new_iters)

    def cond(s: CGState):
        return (s.resnorm > stop) & (s.iters < iter_cap)

    def body(s: CGState):
        Ap = matvec(s.p)
        denom = dot(s.p, Ap)
        alpha = s.rz / jnp.where(denom == 0, 1.0, denom)
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(s.rz == 0, 1.0, s.rz)
        p = z + beta * s.p
        resnorm = jnp.sqrt(jnp.max(dot(r, r)))
        return CGState(x, r, p, z, rz_new, s.iters + 1, resnorm)

    return lax.while_loop(cond, body, init)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def cg_solve_grad(
    matvec_fn: Callable[[Any, jnp.ndarray], jnp.ndarray],
    tol: float,
    max_iters: int,
    params: Any,
    b: jnp.ndarray,
    precond_diag: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Differentiable matrix-free solve x = A(params)^{-1} b for SPD A.

    ``matvec_fn(params, v)`` must apply the FULL operator (kernel matvec
    plus any noise/jitter shift). Reverse-mode goes through the implicit
    function theorem instead of unrolling the CG ``while_loop`` (which JAX
    cannot reverse-differentiate):

        dL/db      = A^{-1} x_bar            (one more CG solve)
        dL/dparams = -w^T (dA/dparams) x,  w = A^{-1} x_bar

    where the params pullback is one VJP of ``matvec_fn`` at the solved x —
    with the Pallas ``gram_matvec`` that is itself a fused tile sweep, so
    large-n LML-style objectives optimise without materialising K anywhere
    in either pass (the GPyTorch/"CG for kernel machines" trick, PAPERS.md).

    ``precond_diag`` only affects convergence speed, never the solution, so
    its gradient is defined as zero.
    """
    state = cg_solve(
        lambda v: matvec_fn(params, v),
        b,
        tol=tol,
        max_iters=max_iters,
        precond_diag=precond_diag,
    )
    return state.x


def _cg_solve_grad_fwd(matvec_fn, tol, max_iters, params, b, precond_diag=None):
    x = cg_solve_grad(matvec_fn, tol, max_iters, params, b, precond_diag)
    return x, (params, x, precond_diag)


def _cg_solve_grad_bwd(matvec_fn, tol, max_iters, res, ct):
    params, x, precond_diag = res
    w = cg_solve(
        lambda v: matvec_fn(params, v),
        ct,
        tol=tol,
        max_iters=max_iters,
        precond_diag=precond_diag,
    ).x
    # params pullback: dL/dp = -<w, (dA/dp) x> via one VJP of the matvec
    _, vjp = jax.vjp(lambda p: matvec_fn(p, x), params)
    (d_params,) = vjp(-w)
    d_pre = None if precond_diag is None else jnp.zeros_like(precond_diag)
    return d_params, w, d_pre


cg_solve_grad.defvjp(_cg_solve_grad_fwd, _cg_solve_grad_bwd)
