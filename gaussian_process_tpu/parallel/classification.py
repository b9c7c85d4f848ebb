"""Distributed binary Laplace GP classification over a device mesh (r5).

The last model family without a scale-out path: regression has the
ring-matvec CG and panel Cholesky, multiclass has the class-sharded
trainer — binary classification ran single-chip only. Here the whole
true-Newton iteration (R&W Alg 3.1, matrix-free like gp.laplace_fit_cg)
runs INSIDE ``shard_map``:

- x, y, and the latent iterate f stay row-sharded over the ``data`` axis;
  W, the gradient and all elementwise link algebra are purely local;
- every B = I + sW K sW matvec is the ring kernel matvec
  (``ppermute`` of the coordinate+vector blocks around the ring) wrapped
  in local sW scalings;
- the preconditioner re-weights the SHARDED Nyström factor per Newton
  step: V = sW . U_local (local), G = I_r + psum(V^T V) (one r^2 psum),
  chol_G replicated — the Woodbury apply costs one (r,) psum per CG
  iteration, exactly like the regression path;
- prediction (Alg 3.2) reduces the cross-gram mean with one psum and the
  latent variance via one block-CG solve whose RHS columns are
  row-sharded.

Padding (arbitrary n) is masked by zeroing W/grad at padded rows — B
acts as the identity there, so they never enter the Krylov space.

No reference equivalent (single-process NumPy throughout,
[ref: GP_binary_classification.py:86-154] — the workload being scaled).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_process_tpu.linalg import cg as _cg
from gaussian_process_tpu.linalg import cholesky as _chol
from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.parallel.cg import (
    _auto_block,
    _landmark_global_indices,
    _nystrom_factor_local,
)


def make_laplace_fit(
    kernel: _k.Kernel,
    *,
    mesh: Mesh,
    axis: str = "data",
    tol: float = None,
    max_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
):
    """Jitted distributed Newton fit: ``(params, x, y) -> (f_mode,
    grad_at_mode, sqrt_w (all row-sharded), iters, inner_iters,
    converged)``. ``y`` in {-1, +1} (zeros at padded rows are masked
    anyway)."""
    if tol is None:
        tol = max(10.0 * float(np.sqrt(np.finfo(np.float32).eps)),
                  float(cg_tol))

    def fn(params, x_local, y_local):
        k_nw, p_nw, white_var = _k.split_white(kernel, params)
        white = white_var if white_var is not None else 0.0
        m_local = x_local.shape[0]
        me = lax.axis_index(axis)
        p = lax.axis_size(axis)
        n_pad_total = m_local * p
        if n_true is not None and n_true != n_pad_total:
            valid = (me * m_local + jnp.arange(m_local)) < n_true
        else:
            valid = None
        _block = block_fn if block_fn is not None else _auto_block(k_nw, p_nw)
        perm = [(i, (i + 1) % p) for i in range(p)]

        def Kmv(v_local):
            vv = v_local[:, None] if v_local.ndim == 1 else v_local

            def body(step, carry):
                xb, vb, acc = carry
                acc = acc + _block(x_local, xb, vb)
                xb = lax.ppermute(xb, axis, perm)
                vb = lax.ppermute(vb, axis, perm)
                return xb, vb, acc

            acc0 = jnp.zeros_like(vv)
            _, _, acc = lax.fori_loop(0, p, body, (x_local, vv, acc0))
            out = acc + white * vv
            if valid is not None:
                out = jnp.where(valid[:, None], out, 0.0)
            return out[:, 0] if v_local.ndim == 1 else out

        n_eff = n_true if n_true is not None else n_pad_total
        U_local = _nystrom_factor_local(
            k_nw, p_nw, x_local,
            axis=axis, g_idx=_landmark_global_indices(n_eff, precond_rank),
            valid=valid,
        )
        r = U_local.shape[1]
        dt = U_local.dtype

        y = jnp.asarray(y_local, dt)
        t = (y + 1.0) / 2.0
        pdot = lambda u, v: lax.psum(jnp.sum(u * v, axis=0), axis)

        def newton_step(f):
            pi = jax.nn.sigmoid(f)
            grad = t - pi
            w = pi * (1.0 - pi)
            if valid is not None:
                # padded rows: W = grad = 0 => B acts as identity there
                grad = jnp.where(valid, grad, 0.0)
                w = jnp.where(valid, w, 0.0)
            sw = jnp.sqrt(w)

            def Bmv(v):
                return v + sw * Kmv(sw * v)

            V = sw[:, None] * U_local
            G = jnp.eye(r, dtype=dt) + lax.psum(
                jnp.dot(V.T, V, preferred_element_type=dt,
                        precision=lax.Precision.HIGHEST),
                axis,
            )
            chol_G = _chol.safe_cholesky(G).factor

            def apply(v):
                wv = lax.psum(
                    jnp.dot(V.T, v[:, None], preferred_element_type=dt,
                            precision=lax.Precision.HIGHEST),
                    axis,
                )
                z = _chol.cholesky_solve(chol_G, wv)
                return v - jnp.dot(
                    V, z, preferred_element_type=dt,
                    precision=lax.Precision.HIGHEST,
                )[:, 0]

            b = w * f + grad
            Kb = Kmv(b)
            st = _cg.cg_solve(
                Bmv, sw * Kb, tol=cg_tol, max_iters=cg_max_iters,
                precond_apply=apply, dot=pdot,
            )
            a = b - sw * st.x
            return Kmv(a), a, sw, grad, st.iters

        f0 = jnp.zeros(m_local, dt)

        def cond(state):
            i, _, err, _ = state
            return (i < max_iters) & (err > tol)

        def body(state):
            i, f, _, inner = state
            f_new, _a, _sw, _g, cg_iters = newton_step(f)
            num = jnp.sqrt(lax.psum(jnp.sum((f_new - f) ** 2), axis))
            den = 1.0 + jnp.sqrt(lax.psum(jnp.sum(f_new ** 2), axis))
            return i + 1, f_new, num / den, inner + cg_iters

        big = jnp.asarray(jnp.inf, dt)
        iters, f, err, inner = lax.while_loop(
            cond, body, (jnp.asarray(0), f0, big, jnp.asarray(0))
        )
        pi = jax.nn.sigmoid(f)
        grad = t - pi
        w = pi * (1.0 - pi)
        if valid is not None:
            grad = jnp.where(valid, grad, 0.0)
            w = jnp.where(valid, w, 0.0)
        return f, grad, jnp.sqrt(w), iters, inner, err <= tol

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_laplace_predict(
    kernel: _k.Kernel,
    *,
    mesh: Mesh,
    axis: str = "data",
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
    block_fn=None,
    n_true: Optional[int] = None,
):
    """Jitted distributed Alg 3.2 prediction: ``(params, x, grad, sw,
    x_test) -> (mean, var, prob, label)`` (all replicated; grad/sw
    row-sharded from :func:`make_laplace_fit`)."""

    def fn(params, x_local, grad_local, sw_local, x_test_rep):
        k_nw, p_nw, white_var = _k.split_white(kernel, params)
        white = white_var if white_var is not None else 0.0
        m_local = x_local.shape[0]
        me = lax.axis_index(axis)
        p = lax.axis_size(axis)
        n_pad_total = m_local * p
        if n_true is not None and n_true != n_pad_total:
            valid = (me * m_local + jnp.arange(m_local)) < n_true
        else:
            valid = None
        _block = block_fn if block_fn is not None else _auto_block(k_nw, p_nw)
        perm = [(i, (i + 1) % p) for i in range(p)]

        def Kmv(vv):
            def body(step, carry):
                xb, vb, acc = carry
                acc = acc + _block(x_local, xb, vb)
                xb = lax.ppermute(xb, axis, perm)
                vb = lax.ppermute(vb, axis, perm)
                return xb, vb, acc

            acc0 = jnp.zeros_like(vv)
            _, _, acc = lax.fori_loop(0, p, body, (x_local, vv, acc0))
            out = acc + white * vv
            if valid is not None:
                out = jnp.where(valid[:, None], out, 0.0)
            return out

        dt = x_local.dtype
        sw = sw_local

        def Bmv(v):
            return v + sw[:, None] * Kmv(sw[:, None] * v)

        n_eff = n_true if n_true is not None else n_pad_total
        U_local = _nystrom_factor_local(
            k_nw, p_nw, x_local,
            axis=axis, g_idx=_landmark_global_indices(n_eff, precond_rank),
            valid=valid,
        )
        r = U_local.shape[1]
        V = sw[:, None] * U_local
        G = jnp.eye(r, dtype=dt) + lax.psum(
            jnp.dot(V.T, V, preferred_element_type=dt,
                    precision=lax.Precision.HIGHEST),
            axis,
        )
        chol_G = _chol.safe_cholesky(G).factor

        def apply(v):
            wv = lax.psum(
                jnp.dot(V.T, v, preferred_element_type=dt,
                        precision=lax.Precision.HIGHEST),
                axis,
            )
            z = _chol.cholesky_solve(chol_G, wv)
            return v - jnp.dot(
                V, z, preferred_element_type=dt,
                precision=lax.Precision.HIGHEST,
            )

        Ks_local = _k.gram(k_nw, p_nw, x_local, x_test_rep,
                           method=dist_method)
        if valid is not None:
            Ks_local = jnp.where(valid[:, None], Ks_local, 0.0)
        pdot = lambda u, v: lax.psum(jnp.sum(u * v, axis=0), axis)
        mean = lax.psum(jnp.dot(
            Ks_local.T, grad_local, precision=lax.Precision.HIGHEST
        ), axis)
        rhs = sw[:, None] * Ks_local
        st = _cg.cg_solve(
            Bmv, rhs, tol=cg_tol, max_iters=cg_max_iters,
            precond_apply=apply, dot=pdot,
        )
        kss = _k.gram_diag(kernel, params, x_test_rep)
        var = jnp.maximum(
            kss - lax.psum(jnp.sum(rhs * st.x, axis=0), axis), 0.0
        )
        prob = jax.nn.sigmoid(mean)
        kappa = 1.0 / jnp.sqrt(1.0 + math.pi * var / 8.0)
        prob_avg = jax.nn.sigmoid(kappa * mean)
        label = jnp.where(prob >= 0.5, 1.0, -1.0)
        return mean, var, prob, prob_avg, label

    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def distributed_fit_predict_binary(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    y: jnp.ndarray,
    x_test: jnp.ndarray,
    *,
    mesh: Mesh,
    axis: str = "data",
    tol: float = None,
    max_iters: int = 100,
    cg_tol: float = 1e-6,
    cg_max_iters: int = 200,
    precond_rank: int = 512,
    dist_method: str = "dot",
):
    """One-shot convenience: pad arbitrary n, fit the Laplace mode and
    predict. Returns ``(prob, prob_averaged, label, mean, var, iters,
    inner_iters, converged)`` with replicated prediction outputs."""
    from gaussian_process_tpu.parallel import mesh as _mesh

    p = mesh.shape[axis]
    n = x.shape[0]
    x_p, _ = _mesh.pad_to_multiple(x, p)
    y_p, _ = _mesh.pad_to_multiple(y, p)
    n_true = None if x_p.shape[0] == n else n
    fit = make_laplace_fit(
        kernel, mesh=mesh, axis=axis, tol=tol, max_iters=max_iters,
        cg_tol=cg_tol, cg_max_iters=cg_max_iters,
        precond_rank=precond_rank, dist_method=dist_method, n_true=n_true,
    )
    f, grad, sw, iters, inner, conv = fit(params, x_p, y_p)
    predict = make_laplace_predict(
        kernel, mesh=mesh, axis=axis, cg_tol=cg_tol,
        cg_max_iters=cg_max_iters, precond_rank=precond_rank,
        dist_method=dist_method, n_true=n_true,
    )
    mean, var, prob, prob_avg, label = predict(params, x_p, grad, sw, x_test)
    return prob, prob_avg, label, mean, var, iters, inner, conv
