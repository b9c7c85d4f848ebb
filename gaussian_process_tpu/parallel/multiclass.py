"""Distributed multi-class Laplace classification — class-parallel over a mesh.

The reference's *disabled* block trainer [ref: GP_multi_classification.py:66-126]
factors one (n x n) block per class; that per-class block structure IS the
distribution axis. Here each device takes a slice of the classes and runs the
corrected Alg. 3.3 Newton step (gp/multiclass.py) locally; the only cross-class
couplings of the algorithm are

    - the softmax normalizer over classes        -> pmax + psum
    - W u = pi u - pi sum_c pi_c u_c             -> one psum
    - sum_c E_c (for M = chol(sum_c E_c))        -> one psum of (n, n)
    - R^T c = sum_c c_c                          -> one psum

so a Newton iteration costs exactly four collectives regardless of C, all
riding the interconnect. Class counts that do not divide the mesh axis are padded with
masked dummy classes: a dummy class has y = 0 and is excluded from the
softmax, so pi = sqrt(W) = V = 0 and it contributes nothing to any psum —
the padded fixed point equals the unpadded one exactly.

The whole Newton ``lax.while_loop`` lives inside one ``shard_map``, so the
compiled program has no per-iteration host round-trips.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_process_tpu import config as _config
from gaussian_process_tpu.gp import multiclass as _mc
from gaussian_process_tpu.linalg import cholesky as _chol
from gaussian_process_tpu.ops import kernels as _k


def _local_newton(K, y_loc, valid_loc, *, axis: str, tol, max_iters):
    """Per-device body: classes sharded over ``axis``; K (n, n) replicated
    (the reference gives every class the same RBF block
    [ref: GP_multi_classification.py:232-238])."""
    Cl, n = y_loc.shape
    dt = K.dtype
    eye = jnp.eye(n, dtype=dt)
    validb = valid_loc[:, None]  # (Cl, 1)
    neg_big = jnp.asarray(-1e30, dt)

    def softmax_parts(f_loc):
        # global column-wise softmax over the sharded class axis
        fm = jnp.where(validb, f_loc, neg_big)
        m = lax.pmax(jnp.max(fm, axis=0), axis)  # (n,)
        e = jnp.where(validb, jnp.exp(f_loc - m[None, :]), 0.0)
        s = lax.psum(jnp.sum(e, axis=0), axis)  # (n,)
        return e / s[None, :], m, s

    def per_class_factor(swc):
        B = eye + swc[:, None] * K * swc[None, :]
        L = lax.linalg.cholesky(B)
        V = lax.linalg.triangular_solve(
            L, jnp.diag(swc), left_side=True, lower=True
        )
        return L, V

    def e_apply(V, u):
        return jnp.dot(
            V.T,
            jnp.dot(V, u, preferred_element_type=dt,
                    precision=lax.Precision.HIGHEST),
            preferred_element_type=dt,
            precision=lax.Precision.HIGHEST,
        )

    def w_apply(pi_loc, u_loc):
        # (D - PI PI^T) u: the class sum crosses devices
        su = lax.psum(jnp.sum(pi_loc * u_loc, axis=0), axis)  # (n,)
        return pi_loc * u_loc - pi_loc * su[None, :]

    def step(f_loc):
        pi, _, _ = softmax_parts(f_loc)
        sw = jnp.sqrt(pi)
        Ls, Vs = jax.vmap(per_class_factor)(sw)

        b = w_apply(pi, f_loc) + y_loc - pi
        Kb = jnp.einsum("ij,cj->ci", K, b, precision=lax.Precision.HIGHEST)
        c_vec = jax.vmap(e_apply)(Vs, Kb)

        E_sum = lax.psum(
            jnp.einsum("cij,cik->jk", Vs, Vs, precision=lax.Precision.HIGHEST),
            axis,
        )
        M = lax.linalg.cholesky(E_sum)
        rc = lax.psum(jnp.sum(c_vec, axis=0), axis)
        m_sol = _chol.cholesky_solve(M, rc)
        a = b - c_vec + jax.vmap(e_apply)(Vs, jnp.broadcast_to(m_sol, (Cl, n)))
        f_new = jnp.einsum("ij,cj->ci", K, a, precision=lax.Precision.HIGHEST)
        return f_new, a, Ls, pi, M

    trace0 = jnp.full((max_iters,), jnp.nan, dtype=dt)
    f0 = jnp.zeros_like(y_loc)

    def cond(state):
        i, _, _, err = state
        return (i < max_iters) & (err > tol)

    def body(state):
        i, f, trace, _ = state
        f_new, *_ = step(f)
        num = jnp.sqrt(lax.psum(jnp.sum((f_new - f) ** 2), axis))
        den = 1.0 + jnp.sqrt(lax.psum(jnp.sum(f_new**2), axis))
        err = num / den
        return i + 1, f_new, trace.at[i].set(err), err

    big = jnp.asarray(jnp.inf, dt)
    iters, f, trace, err = lax.while_loop(
        cond, body, (jnp.asarray(0), f0, trace0, big)
    )

    f_new, a, Ls, pi, M = step(f)
    _, m, s = softmax_parts(f)
    # log-diagonals of dummy-class factors are exactly log diag(chol(I)) = 0,
    # so no valid-mask is needed in the logdet psum. The stacked logdet is
    # sum_c log|B_c| + log|sum_c E_c| (r5 correction, matching
    # gp.laplace_fit_multiclass — see its comment; M is replicated after
    # the E_sum psum, so its term needs NO psum).
    lml = (
        -0.5 * lax.psum(jnp.sum(a * f), axis)
        + lax.psum(jnp.sum(y_loc * f), axis)
        - jnp.sum(m + jnp.log(s))
        - lax.psum(jnp.sum(jnp.log(jnp.diagonal(Ls, axis1=-2, axis2=-1))), axis)
        - jnp.sum(jnp.log(jnp.diagonal(M)))
    )
    return f, pi, lml, iters, err <= tol, trace


def make_sharded_multiclass_fit(
    *,
    mesh: Mesh,
    axis: str = "data",
    tol: float = None,
    max_iters: int = 100,
    dtype=jnp.float32,
):
    """Jitted ``(K, y_pad, valid) -> MulticlassLaplaceState`` with the class
    axis of ``y_pad`` (Cp, n) sharded over mesh axis ``axis``; K replicated."""
    if tol is None:
        tol = 10.0 * float(np.sqrt(np.finfo(np.dtype(dtype)).eps))

    def local(K, y_loc, valid_loc):
        f, pi, lml, iters, conv, trace = _local_newton(
            K, y_loc, valid_loc, axis=axis, tol=tol, max_iters=max_iters
        )
        return f, pi, lml, iters, conv, trace

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def fit(K, y_pad, valid):
        f, pi, lml, iters, conv, trace = sharded(K, y_pad, valid)
        return _mc.MulticlassLaplaceState(
            f_mode=f, pi=pi, lml=lml, iters=iters, converged=conv,
            error_trace=trace,
        )

    return fit


def fit_multiclass_sharded(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: jnp.ndarray,
    y_labels: jnp.ndarray,
    num_classes: int,
    *,
    mesh: Mesh,
    axis: str = "data",
    tol: float = None,
    max_iters: int = 100,
    dist_method: str = "dot",
) -> _mc.MulticlassLaplaceState:
    """Class-parallel Laplace fit; same result as ``gp.fit_multiclass`` with
    the per-class factorizations spread over ``mesh[axis]``. Returns the
    state with padded dummy classes stripped."""
    K = _k.gram(kernel, params, x_train, method=dist_method)
    y = _mc.one_hot_targets(y_labels, num_classes).astype(K.dtype)
    p = int(mesh.shape[axis])
    Cp = -(-num_classes // p) * p
    n = y.shape[1]
    y_pad = jnp.zeros((Cp, n), K.dtype).at[:num_classes].set(y)
    valid = (jnp.arange(Cp) < num_classes)

    fit = make_sharded_multiclass_fit(
        mesh=mesh, axis=axis, tol=tol, max_iters=max_iters, dtype=K.dtype
    )
    class_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    state = fit(
        jax.device_put(K, rep),
        jax.device_put(y_pad, class_sharding),
        jax.device_put(valid, class_sharding),
    )
    return _mc.MulticlassLaplaceState(
        f_mode=state.f_mode[:num_classes],
        pi=state.pi[:num_classes],
        lml=state.lml,
        iters=state.iters,
        converged=state.converged,
        error_trace=state.error_trace,
    )
