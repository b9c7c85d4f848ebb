"""Unit tests: Cholesky/triangular-solve/CG vs scipy (SURVEY.md sec. 4 item 2)."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.linalg import solve_triangular

from gaussian_process_tpu import linalg


def _spd(rng, n, cond=10.0):
    A = rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(A)
    w = np.geomspace(1.0, 1.0 / cond, n)
    return (Q * w) @ Q.T


class TestSafeCholesky:
    def test_matches_numpy_on_spd(self, rng):
        K = _spd(rng, 20)
        res = linalg.safe_cholesky(jnp.asarray(K))
        np.testing.assert_allclose(res.factor, np.linalg.cholesky(K), rtol=1e-8, atol=1e-10)
        assert bool(res.ok)
        assert float(res.jitter) == 0.0

    def test_initial_jitter_applied(self, rng):
        K = _spd(rng, 10)
        res = linalg.safe_cholesky(jnp.asarray(K), initial_jitter=0.5)
        np.testing.assert_allclose(
            res.factor, np.linalg.cholesky(K + 0.5 * np.eye(10)), rtol=1e-8, atol=1e-10
        )

    def test_recovers_from_indefinite(self, rng):
        # rank-deficient PSD matrix: needs jitter escalation
        v = rng.standard_normal((15, 3))
        K = v @ v.T  # rank 3
        res = linalg.safe_cholesky(jnp.asarray(K))
        assert bool(res.ok)
        assert float(res.jitter) > 0.0
        rec = np.asarray(res.factor) @ np.asarray(res.factor).T
        np.testing.assert_allclose(rec, K + float(res.jitter) * np.eye(15), atol=1e-6)

    def test_jittable(self, rng):
        K = _spd(rng, 8)
        f = jax.jit(lambda m: linalg.safe_cholesky(m).factor)
        np.testing.assert_allclose(f(jnp.asarray(K)), np.linalg.cholesky(K), rtol=1e-8, atol=1e-10)

    def test_grad_matches_plain_cholesky(self, rng):
        # On a PSD input (no retry) the custom_vjp pullback must equal the
        # gradient through a plain differentiable factorization.
        K = _spd(rng, 12)

        def via_safe(M):
            return jnp.sum(jnp.log(jnp.diagonal(linalg.safe_cholesky(M).factor)))

        def via_plain(M):
            return jnp.sum(jnp.log(jnp.diagonal(jax.lax.linalg.cholesky(M))))

        g_safe = jax.grad(via_safe)(jnp.asarray(K))
        g_plain = jax.grad(via_plain)(jnp.asarray(K))
        np.testing.assert_allclose(g_safe, g_plain, rtol=1e-8, atol=1e-10)

    def test_grad_with_initial_jitter_under_jit(self, rng):
        K = _spd(rng, 9)

        def loss(M):
            res = linalg.safe_cholesky(M, initial_jitter=0.1)
            return jnp.sum(res.factor**2)

        def loss_plain(M):
            return jnp.sum(jax.lax.linalg.cholesky(M + 0.1 * jnp.eye(9)) ** 2)

        g = jax.jit(jax.grad(loss))(jnp.asarray(K))
        np.testing.assert_allclose(g, jax.grad(loss_plain)(jnp.asarray(K)), rtol=1e-8)

    def test_vmap_grad_mixed_ok_and_retry(self, rng):
        # Batch of two: one SPD (no retry), one rank-deficient (retry fires).
        # The retried element must still get finite gradients and must not
        # poison the clean element's gradient with NaNs.
        K_good = _spd(rng, 10)
        v = rng.standard_normal((10, 2))
        K_bad = v @ v.T  # rank 2: plain chol fails, jitter rescues
        batch = jnp.stack([jnp.asarray(K_good), jnp.asarray(K_bad)])

        def loss(M):
            return jnp.sum(linalg.safe_cholesky(M).factor ** 2)

        vals = jax.vmap(loss)(batch)
        grads = jax.vmap(jax.grad(loss))(batch)
        assert np.isfinite(np.asarray(vals)).all()
        assert np.isfinite(np.asarray(grads)).all()
        g_good_plain = jax.grad(
            lambda M: jnp.sum(jax.lax.linalg.cholesky(M) ** 2)
        )(jnp.asarray(K_good))
        np.testing.assert_allclose(grads[0], g_good_plain, rtol=1e-8, atol=1e-10)

    def test_grad_after_retry_is_finite(self, rng):
        v = rng.standard_normal((8, 2))
        K = jnp.asarray(v @ v.T)

        def loss(M):
            res = linalg.safe_cholesky(M)
            return jnp.sum(res.factor**2)

        g = jax.grad(loss)(K)
        assert np.isfinite(np.asarray(g)).all()


class TestTriSolve:
    def test_forward_backward(self, rng):
        K = _spd(rng, 12)
        L = np.linalg.cholesky(K)
        b = rng.standard_normal(12)
        got_f = linalg.tri_solve(jnp.asarray(L), jnp.asarray(b))
        want_f = solve_triangular(L, b, lower=True)
        np.testing.assert_allclose(got_f, want_f, rtol=1e-9)
        got_b = linalg.tri_solve(jnp.asarray(L), jnp.asarray(b), trans=True)
        want_b = solve_triangular(L.T, b, lower=False)
        np.testing.assert_allclose(got_b, want_b, rtol=1e-9)

    def test_matrix_rhs(self, rng):
        K = _spd(rng, 9)
        L = np.linalg.cholesky(K)
        B = rng.standard_normal((9, 4))
        got = linalg.tri_solve(jnp.asarray(L), jnp.asarray(B))
        np.testing.assert_allclose(got, solve_triangular(L, B, lower=True), rtol=1e-9)

    def test_cholesky_solve(self, rng):
        K = _spd(rng, 14)
        L = np.linalg.cholesky(K)
        b = rng.standard_normal(14)
        got = linalg.cholesky_solve(jnp.asarray(L), jnp.asarray(b))
        np.testing.assert_allclose(got, np.linalg.solve(K, b), rtol=1e-7, atol=1e-9)

    def test_logdet(self, rng):
        K = _spd(rng, 10)
        L = np.linalg.cholesky(K)
        got = linalg.logdet_from_chol(jnp.asarray(L))
        np.testing.assert_allclose(got, np.linalg.slogdet(K)[1], rtol=1e-9)


class TestCG:
    def test_matches_direct_solve(self, rng):
        K = _spd(rng, 50, cond=100.0)
        b = rng.standard_normal(50)
        A = jnp.asarray(K)
        st = linalg.cg_solve(lambda v: A @ v, jnp.asarray(b), tol=1e-12, max_iters=200)
        np.testing.assert_allclose(st.x, np.linalg.solve(K, b), rtol=1e-6, atol=1e-8)

    def test_jacobi_preconditioner_helps(self, rng):
        # badly scaled diagonal: Jacobi should cut iterations
        K = _spd(rng, 60, cond=10.0)
        D = np.diag(np.geomspace(1, 1e4, 60))
        A = D @ K @ D
        b = rng.standard_normal(60)
        Aj = jnp.asarray(A)
        plain = linalg.cg_solve(lambda v: Aj @ v, jnp.asarray(b), tol=1e-10, max_iters=2000)
        pre = linalg.cg_solve(
            lambda v: Aj @ v,
            jnp.asarray(b),
            tol=1e-10,
            max_iters=2000,
            precond_diag=jnp.asarray(np.diag(A)),
        )
        assert int(pre.iters) <= int(plain.iters)
        np.testing.assert_allclose(pre.x, np.linalg.solve(A, b), rtol=1e-5, atol=1e-7)

    def test_block_rhs(self, rng):
        K = _spd(rng, 30)
        B = rng.standard_normal((30, 5))
        A = jnp.asarray(K)
        st = linalg.cg_solve(lambda v: A @ v, jnp.asarray(B), tol=1e-12, max_iters=200)
        np.testing.assert_allclose(st.x, np.linalg.solve(K, B), rtol=1e-6, atol=1e-8)

    def test_jittable(self, rng):
        K = _spd(rng, 20)
        b = rng.standard_normal(20)
        A = jnp.asarray(K)
        f = jax.jit(lambda rhs: linalg.cg_solve(lambda v: A @ v, rhs, tol=1e-12, max_iters=100).x)
        np.testing.assert_allclose(f(jnp.asarray(b)), np.linalg.solve(K, b), rtol=1e-6, atol=1e-8)


class TestNystromPreconditioner:
    """linalg/nystrom.py: application correctness + the convergence win
    over Jacobi that motivates it (see module docstring)."""

    def test_apply_matches_dense_inverse(self, rng):
        from gaussian_process_tpu import ops
        from gaussian_process_tpu.linalg.nystrom import make_nystrom_preconditioner

        n, r = 300, 64
        x = jnp.asarray(rng.uniform(-5, 5, (n, 3)))
        k = ops.RBF()
        p = k.init_params()
        pre = make_nystrom_preconditioner(k, p, x, shift=1e-2, rank=r)
        Q, lam = np.asarray(pre.Q), np.asarray(pre.lam)
        np.testing.assert_allclose(Q.T @ Q, np.eye(r), atol=1e-10)
        # Q diag(lam) Q^T is the Nystrom approximation of K itself
        from gaussian_process_tpu.linalg.nystrom import make_nystrom_factor
        U = np.asarray(make_nystrom_factor(k, p, x, rank=r)[0])
        np.testing.assert_allclose((Q * lam) @ Q.T, U @ U.T, atol=1e-8)
        floor = lam[0] + 1e-2
        P = (Q * (lam + 1e-2)) @ Q.T + floor * (np.eye(n) - Q @ Q.T)
        v = rng.standard_normal(n)
        got = np.asarray(pre.apply(jnp.asarray(v)))
        np.testing.assert_allclose(got, np.linalg.solve(P, v), rtol=1e-7, atol=1e-9)
        # block application too
        V = rng.standard_normal((n, 5))
        gotV = np.asarray(pre.apply(jnp.asarray(V)))
        np.testing.assert_allclose(gotV, np.linalg.solve(P, V), rtol=1e-7, atol=1e-9)

    def test_beats_jacobi_and_agrees(self, rng):
        from gaussian_process_tpu import ops
        from gaussian_process_tpu.linalg.nystrom import make_nystrom_preconditioner

        n = 1500
        x = jnp.asarray(rng.uniform(-5, 5, (n, 4)))
        y = jnp.asarray(rng.standard_normal(n))
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(2.0)}
        shift = 1e-2
        K = ops.gram(k, p, x)
        mv = lambda v: K @ v + shift * v
        pre = make_nystrom_preconditioner(k, p, x, shift=shift, rank=192)
        st_j = linalg.cg_solve(mv, y, tol=1e-8, max_iters=3000,
                               precond_diag=jnp.full(n, 1.0 + shift))
        st_n = linalg.cg_solve(mv, y, tol=1e-8, max_iters=3000,
                               precond_apply=pre.apply)
        assert int(st_n.iters) < int(st_j.iters) // 2
        np.testing.assert_allclose(st_n.x, st_j.x, rtol=1e-5, atol=1e-7)

    def test_posterior_cg_nystrom_matches_cholesky(self, rng):
        from gaussian_process_tpu import gp, ops

        n, m = 900, 40
        x = rng.uniform(-5, 5, (n, 3))
        y = np.sin(0.9 * x.sum(1))
        xs = rng.uniform(-5, 5, (m, 3))
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.5)}
        exact = gp.posterior(k, p, x, y, xs, noise_variance=1e-2)
        cgp = gp.posterior_cg(
            k, p, x, y, xs, noise_variance=1e-2, tol=1e-10,
            preconditioner="nystrom", precond_rank=128,
        )
        np.testing.assert_allclose(cgp.mean, exact.mean, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(cgp.var, exact.var, rtol=1e-3, atol=1e-8)


class TestNystromChunkedBuild:
    def test_chunked_matches_dense(self, rng):
        """The scan-chunked U/G build (O(chunk*rank) workspace) must agree
        with the dense build — incl. a ragged final chunk via row padding
        (r4: the dense build OOMed 16 GB HBM at n=204800, rank=2048)."""
        import jax.numpy as jnp
        from gaussian_process_tpu import ops
        from gaussian_process_tpu.linalg import nystrom

        n = 500  # chunk 128 -> chunks (128,128,128,116-pad)
        x = jnp.asarray(rng.uniform(-5, 5, (n, 3)))
        k = ops.RBF()
        p = k.init_params()
        dense = nystrom.make_nystrom_preconditioner(k, p, x, shift=1e-2, rank=64)
        chunked = nystrom.make_nystrom_preconditioner(
            k, p, x, shift=1e-2, rank=64, row_chunk=128
        )
        np.testing.assert_allclose(np.asarray(chunked.lam), np.asarray(dense.lam),
                                   rtol=1e-9, atol=1e-11)
        v = jnp.asarray(rng.standard_normal(n))
        np.testing.assert_allclose(np.asarray(chunked.apply(v)),
                                   np.asarray(dense.apply(v)),
                                   rtol=1e-8, atol=1e-10)
