"""Integration parity: exact GP regression vs the float64 oracle on the
reference's own configuration (SURVEY.md sec. 4 item 3; BASELINE.json config 1).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_tpu import gp, ops
import oracles

NOISE = 5e-4  # [ref: GP_regression.py:120]


def _reference_dataset(rng, n_train=5, n_test=100):
    """Sine dataset with the reference's construction
    [ref: GP_regression.py:53-68] under a fixed seed."""
    x_train = rng.uniform(-5, 5, size=(n_train, 1))
    y_train = np.sin(0.9 * x_train).ravel() + np.sqrt(NOISE) * rng.standard_normal(n_train)
    x_test = np.linspace(-5, 5, n_test).reshape(-1, 1)
    return x_train, y_train, x_test


class TestExactPosteriorParity:
    def test_mean_var_lml_match_oracle(self, rng):
        x_train, y_train, x_test = _reference_dataset(rng)
        k = ops.RBF()
        p = k.init_params()  # sigma=1, l=1 [ref: GP_regression.py:121,307]

        post = gp.posterior(k, p, x_train, y_train, x_test, noise_variance=NOISE)

        K = oracles.rbf(x_train, x_train, 1.0, 1.0)
        K_s = oracles.rbf(x_train, x_test, 1.0, 1.0)
        kss = np.ones(len(x_test))
        mean, var, lml, L, alpha, v = oracles.exact_posterior(K, K_s, kss, y_train, NOISE)

        np.testing.assert_allclose(post.mean, mean, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(post.var, np.maximum(var, 0), rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(float(post.lml), lml, rtol=1e-10)
        np.testing.assert_allclose(post.alpha, alpha, rtol=1e-9, atol=1e-11)

    def test_larger_problem(self, rng):
        x_train = rng.uniform(-5, 5, size=(200, 3))
        y_train = rng.standard_normal(200)
        x_test = rng.uniform(-5, 5, size=(50, 3))
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.4), "lengthscale": jnp.asarray(2.0)}
        post = gp.posterior(k, p, x_train, y_train, x_test, noise_variance=NOISE)

        K = oracles.rbf(x_train, x_train, 1.4, 2.0)
        K_s = oracles.rbf(x_train, x_test, 1.4, 2.0)
        kss = 1.4**2 * np.ones(50)
        mean, var, lml, *_ = oracles.exact_posterior(K, K_s, kss, y_train, NOISE)
        np.testing.assert_allclose(post.mean, mean, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(post.var, np.maximum(var, 0), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(float(post.lml), lml, rtol=1e-9)

    def test_jit_consistency(self, rng):
        x_train, y_train, x_test = _reference_dataset(rng)
        k = ops.RBF()
        p = k.init_params()
        eager = gp.posterior(k, p, x_train, y_train, x_test)
        jitted = jax.jit(
            lambda pp, xt, yt, xs: gp.posterior(k, pp, xt, yt, xs)
        )(p, x_train, y_train, x_test)
        np.testing.assert_allclose(eager.mean, jitted.mean, rtol=1e-12)
        np.testing.assert_allclose(eager.lml, jitted.lml, rtol=1e-12)


class TestSampling:
    def test_prior_sample_stats(self, rng):
        """RNG paths can't match the reference bitwise (SURVEY.md sec. 7
        'RNG parity') — match distributionally: zero mean, marginal variance
        sigma^2 + s."""
        x = np.linspace(-5, 5, 60).reshape(-1, 1)
        k = ops.RBF()
        p = k.init_params()
        samples = gp.sample_prior(
            k, p, x, jax.random.key(0), num_functions=4000, jitter=NOISE
        )
        assert samples.shape == (60, 4000)
        emp_mean = np.mean(np.asarray(samples))
        emp_var = np.var(np.asarray(samples), axis=1).mean()
        assert abs(emp_mean) < 0.1
        np.testing.assert_allclose(emp_var, 1.0 + NOISE, rtol=0.1)

    def test_posterior_samples_contract_at_train_points(self, rng):
        x_train, y_train, x_test = _reference_dataset(rng, n_train=8)
        k = ops.RBF()
        p = k.init_params()
        post = gp.posterior(k, p, x_train, y_train, x_test, noise_variance=NOISE)
        fs = gp.sample_posterior(
            k, p, post, x_test, jax.random.key(1), num_functions=2000
        )
        assert fs.shape == (100, 2000)
        # empirical marginal variance should track the analytic posterior var
        emp = np.var(np.asarray(fs), axis=1)
        analytic = np.asarray(post.var) + 1e-6
        # loose distributional check
        assert np.corrcoef(emp, analytic)[0, 1] > 0.98


class TestCGPath:
    def test_posterior_mean_cg_matches_chol(self, rng):
        x_train = rng.uniform(-5, 5, size=(120, 2))
        y_train = rng.standard_normal(120)
        x_test = rng.uniform(-5, 5, size=(40, 2))
        k = ops.RBF()
        p = k.init_params()
        post = gp.posterior(k, p, x_train, y_train, x_test, noise_variance=NOISE)

        K = ops.gram(k, p, x_train)
        K_s = ops.gram(k, p, x_train, x_test)
        mean_cg, st = gp.posterior_mean_cg(
            lambda v: K @ v,
            lambda a: K_s.T @ a,
            jnp.asarray(y_train),
            noise_variance=NOISE,
            prior_diag=ops.gram_diag(k, p, x_train),
            tol=1e-8,
            max_iters=500,
        )
        np.testing.assert_allclose(mean_cg, post.mean, rtol=1e-5, atol=1e-7)
        assert int(st.iters) < 500


class TestPosteriorCG:
    """Matrix-free posterior with variance (the large-n path) must match the
    Cholesky path (VERDICT round 1, item 4)."""

    def test_matches_cholesky_path(self, rng):
        import jax.numpy as jnp

        n, m, d = 600, 130, 3
        x = rng.uniform(-5, 5, (n, d))
        y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, d))
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.5)}
        exact = gp.posterior(k, p, x, y, xs, noise_variance=1e-2)
        cg = gp.posterior_cg(
            k, p, x, y, xs, noise_variance=1e-2, tol=1e-10, test_chunk=64
        )
        np.testing.assert_allclose(cg.mean, exact.mean, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(cg.var, exact.var, rtol=1e-3, atol=1e-8)
        assert int(cg.iters) > 0
        assert cg.mean.shape == (m,) and cg.var.shape == (m,)

    def test_white_kernel_handled(self, rng):
        """White noise in the kernel folds into the CG diagonal shift but
        still contributes to the test-point prior diag."""
        import jax.numpy as jnp

        n, m = 300, 40
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF() + ops.White()
        p = (
            {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.0)},
            {"amplitude": jnp.asarray(0.3)},
        )
        exact = gp.posterior(k, p, x, y, xs, noise_variance=1e-3)
        cg = gp.posterior_cg(k, p, x, y, xs, noise_variance=1e-3, tol=1e-10)
        np.testing.assert_allclose(cg.mean, exact.mean, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(cg.var, exact.var, rtol=1e-3, atol=1e-8)

    def test_chunking_invariance(self, rng):
        import jax.numpy as jnp

        n, m = 200, 57  # m not divisible by chunk: padding path
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF()
        p = k.init_params()
        a = gp.posterior_cg(k, p, x, y, xs, test_chunk=16, tol=1e-10)
        b = gp.posterior_cg(k, p, x, y, xs, test_chunk=57, tol=1e-10)
        # rtol 1e-7: different chunkings stop CG at slightly different
        # residuals (block CG iterates to the worst column)
        np.testing.assert_allclose(a.mean, b.mean, rtol=1e-7)
        np.testing.assert_allclose(a.var, b.var, rtol=1e-6, atol=1e-10)


class TestSegmentedCG:
    """posterior_cg_segmented: bounded-latency resumable segments must
    reproduce the monolithic posterior_cg to solver tolerance, and the
    exact-resume (init_state) path must not lose conjugacy."""

    def test_matches_monolithic(self, rng):
        n, m = 300, 20
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF()
        p = k.init_params()
        mono = gp.posterior_cg(k, p, x, y, xs, noise_variance=1e-2,
                               tol=1e-10, test_chunk=8)
        seg = gp.posterior_cg_segmented(k, p, x, y, xs, noise_variance=1e-2,
                                        tol=1e-10, segment_iters=7,
                                        test_chunk=8, precond_rank=64)
        np.testing.assert_allclose(np.asarray(seg.mean), np.asarray(mono.mean),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(seg.var), np.asarray(mono.var),
                                   rtol=1e-4, atol=1e-8)

    def test_exact_resume_preserves_convergence_rate(self, rng):
        """Running k segments of s iters must land where one s*k-iter run
        lands (same Krylov sequence) — the definition of exact resume."""
        from gaussian_process_tpu.linalg import cg as cg_mod

        n = 120
        a = rng.standard_normal((n, n))
        A = a @ a.T + n * np.eye(n)
        b = rng.standard_normal(n)
        mv = lambda v: jnp.asarray(A) @ v
        full = cg_mod.cg_solve(mv, jnp.asarray(b), tol=0.0, max_iters=15)
        state = cg_mod.cg_solve(mv, jnp.asarray(b), tol=0.0, max_iters=15,
                                max_new_iters=5)
        for _ in range(2):
            state = cg_mod.cg_solve(mv, jnp.asarray(b), tol=0.0, max_iters=15,
                                    init_state=state, max_new_iters=5)
        assert int(state.iters) == int(full.iters) == 15
        np.testing.assert_allclose(np.asarray(state.x), np.asarray(full.x),
                                   rtol=1e-10, atol=1e-12)

    def test_checkpoint_callback_sees_states(self, rng):
        n, m = 200, 8
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF()
        seen = []
        gp.posterior_cg_segmented(
            k, k.init_params(), x, y, xs, noise_variance=1e-2, tol=1e-8,
            segment_iters=5, precond_rank=32,
            checkpoint_cb=lambda c, st: seen.append((c, int(st.iters))),
        )
        assert len(seen) >= 2  # multiple segments happened
        iters = [i for _, i in seen]
        assert iters == sorted(iters)  # states progress monotonically

    def test_snapshot_resume_mid_run(self, rng):
        """ADVICE r4 low: posterior_cg_segmented itself resumes — abort the
        solve partway via snapshot_cb, pass the last snapshot back as
        ``resume=``, and the continued run must reproduce the
        uninterrupted answer (mid-chunk, conjugacy preserved)."""
        n, m = 260, 24
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF()
        p = k.init_params()
        kw = dict(noise_variance=1e-2, tol=1e-10, segment_iters=6,
                  test_chunk=8, precond_rank=48)
        ref = gp.posterior_cg_segmented(k, p, x, y, xs, **kw)

        class _Preempt(Exception):
            pass

        snaps = []

        def cb(s):
            snaps.append(s)
            if len(snaps) == 3:
                raise _Preempt()

        try:
            gp.posterior_cg_segmented(k, p, x, y, xs, snapshot_cb=cb, **kw)
        except _Preempt:
            pass
        assert len(snaps) == 3
        resumed = gp.posterior_cg_segmented(
            k, p, x, y, xs, resume=snaps[-1], **kw
        )
        np.testing.assert_allclose(np.asarray(resumed.mean),
                                   np.asarray(ref.mean),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(resumed.var),
                                   np.asarray(ref.var),
                                   rtol=1e-9, atol=1e-11)
        assert int(resumed.iters) == int(ref.iters)

    def test_snapshot_roundtrips_utils_checkpoint(self, rng, tmp_path):
        """The SegmentedSnapshot pytree persists and restores through
        utils.checkpoint (the preemption story end-to-end)."""
        from gaussian_process_tpu.utils import checkpoint as ckpt

        n, m = 200, 16
        x = rng.uniform(-5, 5, (n, 2))
        y = rng.standard_normal(n)
        xs = rng.uniform(-5, 5, (m, 2))
        k = ops.RBF()
        p = k.init_params()
        kw = dict(noise_variance=1e-2, tol=1e-10, segment_iters=5,
                  test_chunk=8, precond_rank=48)
        ref = gp.posterior_cg_segmented(k, p, x, y, xs, **kw)
        snaps = []
        gp.posterior_cg_segmented(k, p, x, y, xs, snapshot_cb=snaps.append,
                                  **kw)
        mid = next(s for s in snaps if s.chunk == 1)
        path = ckpt.save(str(tmp_path / "seg"), mid)
        template = jax.tree_util.tree_map(
            lambda a: jnp.zeros_like(jnp.asarray(a)), mid
        )
        restored_leaves = ckpt.restore(path, template)
        restored = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(mid), jax.tree_util.tree_leaves(restored_leaves)
        )
        restored = gp.SegmentedSnapshot(
            chunk=int(restored.chunk),
            state=restored.state,
            alpha=restored.alpha,
            means=tuple(restored.means),
            variances=tuple(restored.variances),
            total_iters=int(restored.total_iters),
            worst_res=float(restored.worst_res),
        )
        resumed = gp.posterior_cg_segmented(
            k, p, x, y, xs, resume=restored, **kw
        )
        np.testing.assert_allclose(np.asarray(resumed.mean),
                                   np.asarray(ref.mean),
                                   rtol=1e-9, atol=1e-11)

    def test_preemption_resume_via_checkpoint(self, rng, tmp_path):
        """Kill-and-resume: persist the CGState mid-solve with
        utils.checkpoint, 'restart', restore and continue — must land on
        the monolithic answer (SURVEY.md §5 checkpoint/resume: 'resume
        mid-hyperparameter-search and mid-Newton' extended to mid-CG)."""
        from gaussian_process_tpu.linalg import cg as cg_mod
        from gaussian_process_tpu.utils import checkpoint as ckpt

        n = 150
        a = rng.standard_normal((n, n))
        A = a @ a.T + n * np.eye(n)
        b = rng.standard_normal(n)
        mv = lambda v: jnp.asarray(A) @ v

        full = cg_mod.cg_solve(mv, jnp.asarray(b), tol=0.0, max_iters=12)

        # phase 1: run 6 iters, checkpoint, "crash"
        st = cg_mod.cg_solve(mv, jnp.asarray(b), tol=0.0, max_iters=12,
                             max_new_iters=6)
        path = ckpt.save(str(tmp_path / "cg"), st)

        # phase 2: fresh restore (shapes from a zeroed template), continue
        template = jax.tree_util.tree_map(jnp.zeros_like, st)
        st2 = cg_mod.cg_solve(
            mv, jnp.asarray(b), tol=0.0, max_iters=12,
            init_state=cg_mod.CGState(*ckpt.restore(path, template)),
            max_new_iters=6,
        )
        assert int(st2.iters) == 12
        np.testing.assert_allclose(np.asarray(st2.x), np.asarray(full.x),
                                   rtol=1e-10, atol=1e-12)
