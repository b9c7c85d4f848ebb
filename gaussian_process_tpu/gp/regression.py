"""Exact GP regression — Rasmussen & Williams Algorithm 2.1.

Re-derivation of the reference's ``prediction``/``compute_mar_likelihood``
pipeline [ref: GP_regression.py:109-156, tune_hyperparms_regression.py:292-313,
CO2_example.py:131-149,182-214] as pure jittable functions:

    K   = k(X, X) + s I          (jittered Cholesky, NaN-guarded)
    L   = chol(K)
    a   = L^T \\ (L \\ y)
    mu* = K_s^T a
    v   = L \\ K_s
    var*= diag(K_ss) - sum(v^2, 0)
    LML = -0.5 y^T a - sum(log diag L) - n/2 log(2 pi)

Differences from the reference (all deliberate):
- one fused jitted program instead of five separate NumPy calls, so XLA
  fuses kernel construction into the factorization's producers;
- ``diag(K_ss)`` via ``gram_diag`` — the reference materialises the full
  (n_test, n_test) matrix just to take its diagonal [ref: GP_regression.py:128,147];
- the LML uses the *corrected* formula (reference quirk Q1: the inline
  version at GP_regression.py:151 drops the log and normalises by the test
  count);
- no ``np.linalg.inv`` anywhere (the reference inverts triangular factors
  [ref: CO2_example.py:144]); triangular solves throughout;
- a matrix-free CG path (``posterior_mean_cg``) for n where K cannot be
  materialised.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from gaussian_process_tpu import config as _config
from gaussian_process_tpu.linalg import cholesky as _chol
from gaussian_process_tpu.linalg import cg as _cg
from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.ops import matvec as _mv


def _solve_cfg(cfg):
    return _config.DEFAULT_SOLVE if cfg is None else cfg


class Posterior(NamedTuple):
    mean: jnp.ndarray  # (n_test,) posterior mean mu*
    var: jnp.ndarray  # (n_test,) posterior marginal variance
    std: jnp.ndarray  # sqrt(var)
    lml: jnp.ndarray  # scalar log marginal likelihood (corrected formula)
    chol: jnp.ndarray  # (n_train, n_train) L with K + sI = L L^T
    alpha: jnp.ndarray  # (n_train,) K^-1 y
    v: jnp.ndarray  # (n_train, n_test) L \\ K_s (for joint sampling)
    jitter: jnp.ndarray  # extra jitter applied beyond the noise term


def posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: jnp.ndarray,
    y_train: jnp.ndarray,
    x_test: jnp.ndarray,
    *,
    noise_variance: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> Posterior:
    """Full exact-GP posterior at ``x_test`` (Alg. 2.1).

    [ref: GP_regression.py:109-156 (prediction)]

    ``cfg`` (config.SolveConfig) carries every numeric knob — observation
    noise, jitter-retry policy — with the reference's constants as defaults
    (SURVEY.md Q6); an explicit ``noise_variance`` overrides it.
    """
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    with jax.named_scope("gp.gram"):
        K = _k.gram(kernel, params, x_train, method=dist_method)
        K_s = _k.gram(kernel, params, x_train, x_test, method=dist_method)
        kss_diag = _k.gram_diag(kernel, params, x_test)

    with jax.named_scope("gp.factorize"):
        res = _chol.safe_cholesky(
            K,
            initial_jitter=noise_variance,
            jitter_growth=cfg.jitter_growth,
            max_attempts=cfg.max_chol_attempts,
        )
        L = res.factor
    with jax.named_scope("gp.solve"):
        # y rides the K_s forward solve (one batched TRSM instead of two).
        # With z = L^{-1}[y | K_s]:
        #   y^T alpha = z_y^T z_y,   var* = diag(K_ss) - sum(v^2)
        rhs = jnp.concatenate([y_train[:, None], K_s], axis=1)
        z_all = _chol.tri_solve(L, rhs)
        z_y = z_all[:, 0]
        v = z_all[:, 1:]
        alpha = _chol.tri_solve(L, z_y, trans=True)

    with jax.named_scope("gp.predict"):
        # HIGHEST: a bare f32 dot may run in TF32 on a GPU, whose ~1e-3
        # relative error would swamp the 5e-4 mean gate
        mean = jnp.dot(
            K_s.T, alpha, preferred_element_type=K_s.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        var = kss_diag - jnp.sum(v * v, axis=0)
        var = jnp.maximum(var, 0.0)

    n = x_train.shape[0]
    with jax.named_scope("gp.lml"):
        lml = (
            -0.5 * jnp.dot(z_y, z_y)
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * math.log(2.0 * math.pi)
        )
    return Posterior(
        mean=mean,
        var=var,
        std=jnp.sqrt(var),
        lml=lml,
        chol=L,
        alpha=alpha,
        v=v,
        jitter=res.jitter,
    )


def log_marginal_likelihood(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: jnp.ndarray,
    y_train: jnp.ndarray,
    *,
    noise_variance: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> jnp.ndarray:
    """Corrected LML — differentiable in ``params`` via jax.grad.

    [ref: tune_hyperparms_regression.py:292-313 (compute_mar_likelihood);
    the hand-derived RBF gradient it replaces is at :31-64]
    """
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    with jax.named_scope("gp.gram"):
        K = _k.gram(kernel, params, x_train, method=dist_method)
    with jax.named_scope("gp.factorize"):
        res = _chol.safe_cholesky(
            K,
            initial_jitter=noise_variance,
            jitter_growth=cfg.jitter_growth,
            max_attempts=cfg.max_chol_attempts,
        )
        L = res.factor
    with jax.named_scope("gp.solve"):
        alpha = _chol.cholesky_solve(L, y_train)
    n = x_train.shape[0]
    with jax.named_scope("gp.lml"):
        return (
            -0.5 * jnp.dot(y_train, alpha)
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * math.log(2.0 * math.pi)
        )


def sample_prior(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    key: jax.Array,
    *,
    num_functions: int = 10,
    jitter: float = 5e-4,
    mean: float = 0.0,
    dist_method: str = "dot",
) -> jnp.ndarray:
    """Draw ``num_functions`` GP prior paths at ``x``: mu + L N(0, I).

    [ref: GP_regression.py:71-92 (f_prior); its jitter s = 5e-4 at :81,90]
    """
    K = _k.gram(kernel, params, x, method=dist_method)
    res = _chol.safe_cholesky(K, initial_jitter=jitter)
    n = x.shape[0]
    eps = jax.random.normal(key, (n, num_functions), dtype=K.dtype)
    return mean + jnp.dot(
        res.factor,
        eps,
        preferred_element_type=K.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def sample_posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    post: Posterior,
    x_test: jnp.ndarray,
    key: jax.Array,
    *,
    num_functions: int = 10,
    jitter: Optional[float] = None,
    dist_method: str = "dot",
    cfg: Optional[_config.SolveConfig] = None,
) -> jnp.ndarray:
    """Joint posterior samples at the test points.

    chol(K_ss + jitter I - v^T v) [ref: GP_regression.py:154-155; the 1e-6
    jitter is the reference's constant].
    """
    if jitter is None:
        jitter = _solve_cfg(cfg).sampling_jitter
    K_ss = _k.gram(kernel, params, x_test, method=dist_method)
    # HIGHEST: bf16-default v^T v error would swamp the 1e-6 sampling jitter
    # and force huge jitter escalation in the cov factorization.
    cov = K_ss - jnp.dot(
        post.v.T,
        post.v,
        preferred_element_type=K_ss.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    res = _chol.safe_cholesky(cov, initial_jitter=jitter)
    n = x_test.shape[0]
    eps = jax.random.normal(key, (n, num_functions), dtype=K_ss.dtype)
    return post.mean[:, None] + jnp.dot(
        res.factor,
        eps,
        preferred_element_type=K_ss.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


class CGPosterior(NamedTuple):
    mean: jnp.ndarray  # (n_test,)
    var: jnp.ndarray  # (n_test,) predictive marginal variance
    std: jnp.ndarray
    iters: jnp.ndarray  # total CG iterations across all solves
    resnorm: jnp.ndarray  # worst final residual norm across solves


def posterior_cg(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: jnp.ndarray,
    y_train: jnp.ndarray,
    x_test: jnp.ndarray,
    *,
    noise_variance: Optional[float] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    test_chunk: int = 512,
    use_pallas: Optional[bool] = None,
    preconditioner: str = "auto",
    precond_rank: Optional[int] = None,
    cfg: Optional[_config.SolveConfig] = None,
) -> CGPosterior:
    """Matrix-free exact-GP posterior (mean AND variance) at large n.

    K(X, X) is never materialised: every matvec goes through
    ``ops.gram_matvec`` (the fused kernel on a GPU, XLA row blocks
    elsewhere; ``use_pallas`` overrides the choice, see
    ``ops.matvec_path``).
    The predictive variance is computed exactly (to CG tolerance), not by
    stochastic estimation: for each chunk C of test points,

        U = (K + s I)^{-1} K_sC        (one block-CG solve, |C| RHS share
                                        every kernel tile per iteration)
        var_C = diag(K_CC) - sum(K_sC * U, axis=0)

    which is the v = L \\ K_s variance of Alg. 2.1 [ref: GP_regression.py:
    144-147] with the triangular solve replaced by CG. alpha rides the
    first chunk's block solve as an extra RHS. Memory: O(n * test_chunk).

    ``preconditioner``: "nystrom" (rank-``precond_rank`` landmark
    preconditioner, linalg/nystrom.py — the large-n default: Jacobi CG
    stalls at n ~ 100k where kappa ~ 1e6), "jacobi", "none", or "auto"
    (nystrom above n = 4096, jacobi below). ``precond_rank=None`` scales
    the rank with n: min(2048, max(512, n // 50)); at n = 102400 rank 1024
    needed about three times the CG iterations of rank 2048.

    The reference has no large-n path at all (dense factorization only,
    [ref: GP_regression.py:138]); this is the n ~ 100k single-chip path
    (BASELINE.md row 2). For the distributed version see
    ``parallel.cg.make_posterior_cg``.
    """
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    if tol is None:
        tol = cfg.cg_tol
    if max_iters is None:
        max_iters = cfg.cg_max_iters
    x_train = jnp.atleast_2d(x_train)
    x_test = jnp.atleast_2d(x_test)
    n = x_train.shape[0]
    m = x_test.shape[0]

    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    shift = noise_variance + (white_var if white_var is not None else 0.0)

    matvec = lambda v: _mv.gram_matvec(
        k_nw, p_nw, x_train, None, v, use_pallas=use_pallas
    )
    cross_chunk = lambda xc: _k.gram(k_nw, p_nw, x_train, xc)

    noisy_mv = lambda v: matvec(v) + shift * v
    if preconditioner == "auto":
        preconditioner = "nystrom" if n > 4096 else "jacobi"
    if precond_rank is None:
        precond_rank = min(2048, max(512, n // 50))
    if preconditioner == "nystrom":
        from gaussian_process_tpu.linalg import nystrom as _nys

        pre = _nys.make_nystrom_preconditioner(
            k_nw, p_nw, x_train, shift=shift, rank=precond_rank
        )
        precond_kwargs = {"precond_apply": pre.apply}
    elif preconditioner == "jacobi":
        precond_kwargs = {
            "precond_diag": _k.gram_diag(k_nw, p_nw, x_train) + shift
        }
    elif preconditioner == "none":
        precond_kwargs = {}
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    # chunked test points; pad the last chunk to keep shapes static
    chunk = min(test_chunk, m)
    n_chunks = -(-m // chunk)
    m_pad = n_chunks * chunk
    x_test_p = jnp.pad(x_test, ((0, m_pad - m), (0, 0)))

    kss = _k.gram_diag(kernel, params, x_test_p)  # full kernel: white counts
    means, vars = [], []
    total_iters = jnp.asarray(0)
    worst_res = jnp.asarray(0.0, x_train.dtype)
    alpha = None
    for c in range(n_chunks):
        xc = x_test_p[c * chunk : (c + 1) * chunk]
        Ks = cross_chunk(xc)  # (n, chunk)
        rhs = jnp.concatenate([y_train[:, None], Ks], axis=1) if c == 0 else Ks
        state = _cg.cg_solve(
            noisy_mv,
            rhs,
            tol=tol,
            max_iters=max_iters,
            **precond_kwargs,
        )
        U = state.x
        if c == 0:
            alpha = U[:, 0]
            U = U[:, 1:]
        means.append(jnp.dot(Ks.T, alpha, precision=jax.lax.Precision.HIGHEST))
        vars.append(
            kss[c * chunk : (c + 1) * chunk] - jnp.sum(Ks * U, axis=0)
        )
        total_iters = total_iters + state.iters
        worst_res = jnp.maximum(worst_res, state.resnorm)

    mean = jnp.concatenate(means)[:m]
    var = jnp.maximum(jnp.concatenate(vars)[:m], 0.0)
    return CGPosterior(
        mean=mean,
        var=var,
        std=jnp.sqrt(var),
        iters=total_iters,
        resnorm=worst_res,
    )


def posterior_mean_cg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    cross_mv: Callable[[jnp.ndarray], jnp.ndarray],
    y_train: jnp.ndarray,
    *,
    noise_variance: float = 5e-4,
    prior_diag: Optional[jnp.ndarray] = None,
    tol: float = 1e-6,
    max_iters: int = 1000,
) -> tuple[jnp.ndarray, _cg.CGState]:
    """Posterior mean via matrix-free CG: mu* = K_s^T (K + sI)^-1 y.

    ``matvec(v)`` must return K(X,X) @ v (without noise); ``cross_mv(alpha)``
    returns K_s^T @ alpha. This is the large-n path where K is never
    materialised (no reference equivalent — it densifies always).
    """
    noisy_mv = lambda v: matvec(v) + noise_variance * v
    diag = None if prior_diag is None else prior_diag + noise_variance
    state = _cg.cg_solve(
        noisy_mv, y_train, tol=tol, max_iters=max_iters, precond_diag=diag
    )
    return cross_mv(state.x), state


class SegmentedSnapshot(NamedTuple):
    """Complete resumable state of a :func:`posterior_cg_segmented` run.

    Emitted via ``snapshot_cb`` after every segment and accepted back via
    ``resume=``: a fresh process can continue the solve exactly where a
    preempted one stopped — mid-chunk, conjugacy preserved (cg_solve
    ``init_state``), with all finished chunks' results carried along.
    Every leaf is an array or a scalar, so the whole tuple round-trips
    through ``utils.checkpoint`` (tested in tests/test_regression.py).
    ADVICE r4 low: the previous API could only checkpoint, not resume.
    """

    chunk: int  # index of the chunk the ``state`` belongs to
    state: "_cg.CGState"  # mid-solve CG state of that chunk
    alpha: Optional[jnp.ndarray]  # (n,) weights, once chunk 0 finished
    means: tuple  # finished chunks' posterior-mean blocks
    variances: tuple  # finished chunks' variance blocks
    total_iters: int  # CG iterations spent in FINISHED chunks
    worst_res: float  # worst final residual across finished chunks


def posterior_cg_segmented(
    kernel: _k.Kernel,
    params: _k.Params,
    x_train: jnp.ndarray,
    y_train: jnp.ndarray,
    x_test: jnp.ndarray,
    *,
    noise_variance: Optional[float] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    segment_iters: int = 40,
    test_chunk: int = 8,
    use_pallas: Optional[bool] = None,
    precond_rank: Optional[int] = None,
    checkpoint_cb=None,
    snapshot_cb=None,
    resume: Optional[SegmentedSnapshot] = None,
    cfg: Optional[_config.SolveConfig] = None,
) -> CGPosterior:
    """Matrix-free posterior like :func:`posterior_cg`, but as a host loop
    of BOUNDED device calls: each call runs at most ``segment_iters`` CG
    iterations and returns the full :class:`linalg.cg.CGState`, which the
    next call resumes EXACTLY (conjugacy preserved — see cg_solve's
    ``init_state``; this is not an x0 restart).

    Why: the solve checkpoints AND resumes, so a preempted or
    time-limited job loses at most one segment of work: ``snapshot_cb`` receives a complete
    :class:`SegmentedSnapshot` after every segment (persist it with
    utils.checkpoint), and passing one back as ``resume=`` continues the
    solve exactly — mid-chunk, conjugacy preserved, finished chunks not
    recomputed (SURVEY.md §5 checkpoint/resume row). ``checkpoint_cb``
    (called as ``checkpoint_cb(chunk_index, CGState)``) is the older
    state-only hook and still fires.

    The Nystrom preconditioner is built ONCE in its own jitted call and
    then passed to every segment as a pytree argument (NamedTuple of
    arrays), so no 100s-of-MB factor is ever baked into a compile payload.
    Results match :func:`posterior_cg` to solver tolerance (tests).
    """
    cfg = _solve_cfg(cfg)
    if noise_variance is None:
        noise_variance = cfg.noise_variance
    if tol is None:
        tol = cfg.cg_tol
    if max_iters is None:
        max_iters = cfg.cg_max_iters
    x_train = jnp.atleast_2d(x_train)
    x_test = jnp.atleast_2d(x_test)
    n = x_train.shape[0]
    m = x_test.shape[0]

    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    shift = noise_variance + (white_var if white_var is not None else 0.0)
    if precond_rank is None:
        precond_rank = min(2048, max(512, n // 50))

    from gaussian_process_tpu.linalg import nystrom as _nys

    @jax.jit
    def build_pre(p_nw, x):
        return _nys.make_nystrom_preconditioner(
            k_nw, p_nw, x, shift=shift, rank=min(precond_rank, n)
        )

    def noisy_mv(p_nw, x, v):
        return _mv.gram_matvec(
            k_nw, p_nw, x, None, v, use_pallas=use_pallas
        ) + shift * v

    @jax.jit
    def seg_first(p_nw, x, rhs, pre):
        return _cg.cg_solve(
            lambda v: noisy_mv(p_nw, x, v), rhs, tol=tol, max_iters=max_iters,
            precond_apply=pre.apply, max_new_iters=segment_iters,
        )

    @jax.jit
    def seg_cont(p_nw, x, rhs, pre, state):
        return _cg.cg_solve(
            lambda v: noisy_mv(p_nw, x, v), rhs, tol=tol, max_iters=max_iters,
            precond_apply=pre.apply, init_state=state,
            max_new_iters=segment_iters,
        )

    @jax.jit
    def cross(p_nw, x, xc):
        return _k.gram(k_nw, p_nw, x, xc)

    pre = build_pre(p_nw, x_train)

    chunk = min(test_chunk, m)
    n_chunks = -(-m // chunk)
    m_pad = n_chunks * chunk
    x_test_p = jnp.pad(x_test, ((0, m_pad - m), (0, 0)))
    kss = _k.gram_diag(kernel, params, x_test_p)

    if resume is not None:
        start_chunk = int(resume.chunk)
        means = list(resume.means)
        vars_ = list(resume.variances)
        alpha = resume.alpha
        total_iters = int(resume.total_iters)
        worst_res = float(resume.worst_res)
    else:
        start_chunk = 0
        means, vars_ = [], []
        total_iters = 0
        worst_res = 0.0
        alpha = None
    for c in range(start_chunk, n_chunks):
        xc = x_test_p[c * chunk : (c + 1) * chunk]
        Ks = cross(p_nw, x_train, xc)
        rhs = jnp.concatenate([y_train[:, None], Ks], axis=1) if c == 0 else Ks
        stop = float(tol) * max(
            float(jnp.sqrt(jnp.max(jnp.sum(rhs * rhs, axis=0)))), 1e-30
        )

        def _emit_cb(state):
            if checkpoint_cb is not None:
                checkpoint_cb(c, state)
            if snapshot_cb is not None:
                snapshot_cb(SegmentedSnapshot(
                    chunk=c, state=state, alpha=alpha,
                    means=tuple(means), variances=tuple(vars_),
                    total_iters=total_iters, worst_res=worst_res,
                ))

        if resume is not None and c == start_chunk:
            # continue the interrupted chunk exactly from its CG state
            state = seg_cont(p_nw, x_train, rhs, pre, resume.state)
        else:
            state = seg_first(p_nw, x_train, rhs, pre)
        _emit_cb(state)
        while (
            float(state.resnorm) > stop and int(state.iters) < max_iters
        ):
            prev_iters = int(state.iters)
            state = seg_cont(p_nw, x_train, rhs, pre, state)
            _emit_cb(state)
            if int(state.iters) == prev_iters:
                break  # no progress possible (cap reached inside)
        U = state.x
        if c == 0:
            alpha = U[:, 0]
            U = U[:, 1:]
        means.append(jnp.dot(Ks.T, alpha, precision=jax.lax.Precision.HIGHEST))
        vars_.append(
            kss[c * chunk : (c + 1) * chunk] - jnp.sum(Ks * U, axis=0)
        )
        total_iters += int(state.iters)
        worst_res = max(worst_res, float(state.resnorm))

    mean = jnp.concatenate(means)[:m]
    var = jnp.maximum(jnp.concatenate(vars_)[:m], 0.0)
    return CGPosterior(
        mean=mean,
        var=var,
        std=jnp.sqrt(var),
        iters=jnp.asarray(total_iters),
        resnorm=jnp.asarray(worst_res, x_train.dtype),
    )
