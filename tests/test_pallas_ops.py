"""The kernel matvec: the fused Pallas/Triton kernel (interpret mode on
CPU), the XLA row-block path, the choice between them, and the custom VJP,
each against a dense float64 product.

SURVEY.md sec. 4 item 1: 'Pallas kernel-matrix tiles vs jnp dense reference'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_tpu import ops
from gaussian_process_tpu.ops import matvec as mv
from gaussian_process_tpu.ops.pallas import kernel_matvec as km


def _x(rng, n, d):
    return rng.uniform(-5, 5, size=(n, d)).astype(np.float32)


def _f64(tree):
    return jax.tree_util.tree_map(lambda z: jnp.asarray(z, jnp.float64), tree)


def _dense(kernel, params, a, b, v):
    """float64 K(a, b) @ v (b=None: the same set, White included)."""
    a64 = jnp.asarray(a, jnp.float64)
    b64 = None if b is None else jnp.asarray(b, jnp.float64)
    K = np.asarray(ops.gram(kernel, _f64(params), a64, b64))
    return K @ np.asarray(v, np.float64)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


KERNELS = {
    "rbf": (ops.RBF(), {"sigma": 1.3, "lengthscale": 0.7}),
    "matern05": (ops.Matern(nu=0.5), {"sigma": 1.1, "lengthscale": 0.9}),
    "matern15": (ops.Matern(nu=1.5), {"sigma": 1.1, "lengthscale": 0.9}),
    "matern25": (ops.Matern(nu=2.5), {"sigma": 0.8, "lengthscale": 1.4}),
    "rbf_white": (ops.RBF() + ops.White(),
                  ({"sigma": 1.0, "lengthscale": 1.1}, {"amplitude": 0.5})),
}


def _kernel(name):
    k, p = KERNELS[name]
    return k, jax.tree_util.tree_map(lambda z: jnp.asarray(z, jnp.float32), p)


class TestFusedMatvec:
    """The Triton kernel, interpreted; n=150 is not a multiple of the
    64-row tile, so every call also covers the padded tail."""

    @pytest.mark.parametrize("r", [1, 4, 16])
    @pytest.mark.parametrize("name", list(KERNELS))
    def test_matches_xla_and_dense(self, rng, name, r):
        k, p = _kernel(name)
        a = _x(rng, 150, 3)
        v = rng.standard_normal((150, r)).astype(np.float32)
        got = ops.gram_matvec(k, p, a, None, jnp.asarray(v), interpret=True)
        xla = ops.gram_matvec(k, p, a, None, jnp.asarray(v), use_pallas=False)
        want = _dense(k, p, a, None, v)
        assert _rel(got, want) < 2e-5
        assert _rel(got, np.asarray(xla, np.float64)) < 2e-5

    def test_cross_set_ragged(self, rng):
        k, p = _kernel("matern15")
        a, b = _x(rng, 100, 2), _x(rng, 77, 2)
        v = rng.standard_normal((77, 3)).astype(np.float32)
        got = km.fused_matvec(k, p, a, b, jnp.asarray(v), interpret=True)
        assert got.shape == (100, 3)
        assert _rel(got, _dense(k, p, a, b, v)) < 2e-5

    def test_wide_rhs_splits_over_grid(self, rng):
        """r wider than the 64-column RHS block runs as several programs
        along the grid's second axis, the last one on a padded slice."""
        k, p = _kernel("rbf")
        a = _x(rng, 70, 4)
        v = rng.standard_normal((70, 100)).astype(np.float32)
        got = km.fused_matvec(k, p, a, a, jnp.asarray(v), interpret=True)
        assert _rel(got, _dense(k, p, a, a, v)) < 2e-5

    def test_rejects_nonstationary(self, rng):
        a = _x(rng, 16, 2)
        with pytest.raises(ValueError):
            km.fused_matvec(ops.Linear(), ops.Linear().init_params(), a, a,
                            jnp.ones((16, 1), jnp.float32), interpret=True)

    def test_rejects_wide_inputs(self, rng):
        a = _x(rng, 16, km.MAX_D + 1)
        k, p = _kernel("rbf")
        with pytest.raises(ValueError):
            km.fused_matvec(k, p, a, a, jnp.ones((16, 1), jnp.float32),
                            interpret=True)


class TestPallasMatvec:
    """``ops.gram_matvec`` through the fused kernel, interpreted."""

    @pytest.mark.parametrize("r", [None, 1, 4])
    def test_matches_dense_matvec(self, rng, r):
        a, b = _x(rng, 300, 3), _x(rng, 200, 3)
        v = rng.standard_normal((200,) if r is None else (200, r)).astype(np.float32)
        k, p = ops.RBF(), {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)}
        got = ops.gram_matvec(k, p, a, b, jnp.asarray(v), interpret=True)
        assert got.shape == (300,) + v.shape[1:]
        np.testing.assert_allclose(got, _dense(k, p, a, b, v), rtol=2e-4, atol=2e-4)

    def test_same_set_with_white(self, rng):
        a = _x(rng, 130, 2)
        v = rng.standard_normal(130).astype(np.float32)
        k, p = _kernel("rbf_white")
        got = ops.gram_matvec(k, p, a, None, jnp.asarray(v), interpret=True)
        np.testing.assert_allclose(got, _dense(k, p, a, None, v), rtol=2e-4, atol=2e-4)

    def test_tile_size_invariance(self, rng):
        """Each path agrees with itself at two tilings: the fused kernel at
        two tile shapes, the XLA path (in f64, where its slab-wise
        centering cannot show) at two slab heights."""
        k, p = _kernel("rbf")
        a = jnp.asarray(_x(rng, 100, 2))
        v = jnp.asarray(rng.standard_normal((100, 1)).astype(np.float32))
        g1 = km.fused_matvec(k, p, a, a, v, interpret=True)
        g2 = km.fused_matvec(k, p, a, a, v, block_m=32, block_n=16, interpret=True)
        np.testing.assert_allclose(g1, g2, rtol=2e-5, atol=2e-5)
        a64, v64, p64 = jnp.asarray(a, jnp.float64), jnp.asarray(v, jnp.float64), _f64(p)
        g3 = ops.xla_matvec(k, p64, a64, a64, v64, block=7)
        g4 = ops.xla_matvec(k, p64, a64, a64, v64)
        np.testing.assert_allclose(g3, g4, rtol=1e-12, atol=1e-12)

    def test_pure_white_is_diagonal(self, rng):
        a = _x(rng, 20, 2)
        v = jnp.asarray(rng.standard_normal(20))
        got = ops.gram_matvec(ops.White(), {"amplitude": jnp.asarray(0.5)}, a, None, v)
        np.testing.assert_allclose(got, 0.25 * np.asarray(v), rtol=1e-12)


class TestXlaMatvec:
    @pytest.mark.parametrize("block", [None, 1, 7, 64, 500])
    def test_matches_dense(self, rng, block):
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.2), "lengthscale": jnp.asarray(0.8)}
        a, b = rng.uniform(-3, 3, (90, 3)), rng.uniform(-3, 3, (45, 3))
        v = rng.standard_normal((45, 5))
        got = ops.xla_matvec(k, p, jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), block=block)
        np.testing.assert_allclose(got, _dense(k, p, a, b, v), rtol=1e-12, atol=1e-12)

    def test_nonstationary_kernel(self, rng):
        k = ops.Linear()
        p = k.init_params()
        a = rng.uniform(-3, 3, (40, 2))
        v = rng.standard_normal((40, 2))
        got = ops.gram_matvec(k, p, jnp.asarray(a), None, jnp.asarray(v))
        np.testing.assert_allclose(got, _dense(k, p, a, None, v), rtol=1e-12, atol=1e-12)

    def test_slab_size_bounds_memory(self):
        assert mv._row_block(102400, 102400) * 102400 <= mv._SLAB_ELEMS
        assert mv._row_block(10, 10) == 10


class TestMatvecPath:
    """The one selection point: fused kernel on a GPU for stationary f32
    work up to FUSED_MAX_R columns, XLA otherwise; interpreted only when
    asked."""

    X32 = jnp.zeros((8, 3), jnp.float32)

    @pytest.fixture
    def on_gpu(self, monkeypatch):
        monkeypatch.setattr(mv.jax, "default_backend", lambda: "gpu")

    def test_gpu_stationary_gets_fused(self, on_gpu):
        assert ops.matvec_path(ops.RBF(), self.X32, 16) == "fused"
        assert ops.matvec_path(ops.Matern(nu=1.5), self.X32, 1) == "fused"

    def test_gpu_nonstationary_gets_xla(self, on_gpu):
        assert ops.matvec_path(ops.Linear(), self.X32, 16) == "xla"

    def test_gpu_wide_rhs_gets_xla(self, on_gpu):
        assert ops.matvec_path(ops.RBF(), self.X32, mv.FUSED_MAX_R) == "fused"
        assert ops.matvec_path(ops.RBF(), self.X32, mv.FUSED_MAX_R + 1) == "xla"

    def test_gpu_f64_or_wide_inputs_get_xla(self, on_gpu):
        assert ops.matvec_path(ops.RBF(), jnp.zeros((8, 3), jnp.float64), 1) == "xla"
        wide = jnp.zeros((8, km.MAX_D + 1), jnp.float32)
        assert ops.matvec_path(ops.RBF(), wide, 1) == "xla"

    def test_cpu_gets_xla(self):
        assert ops.matvec_path(ops.RBF(), self.X32, 16) == "xla"

    def test_interpret_only_when_asked(self):
        assert ops.matvec_path(ops.RBF(), self.X32, 1, interpret=True) == "fused_interpret"
        assert ops.matvec_path(ops.RBF(), self.X32, 1, use_pallas=True,
                               interpret=True) == "fused_interpret"

    def test_use_pallas_overrides(self, on_gpu):
        assert ops.matvec_path(ops.RBF(), self.X32, 1, use_pallas=False) == "xla"
        assert ops.matvec_path(ops.RBF(), self.X32, 1000, use_pallas=True) == "fused"
        with pytest.raises(ValueError):
            ops.matvec_path(ops.Linear(), self.X32, 1, use_pallas=True)

    def test_cpu_solvers_never_run_the_kernel(self, rng, monkeypatch):
        """No interpret mode unless asked: on CPU every solver's matvec goes
        through XLA, so the fused kernel is never called."""
        from gaussian_process_tpu import gp

        def boom(*a, **k):
            raise AssertionError("fused kernel called without interpret=True")

        monkeypatch.setattr(km, "fused_matvec", boom)
        x = _x(rng, 64, 2)
        y = jnp.asarray(rng.standard_normal(64).astype(np.float32))
        k, p = _kernel("rbf")
        post = gp.posterior_cg(k, p, x, y, x[:4], tol=1e-4, precond_rank=16)
        assert np.all(np.isfinite(np.asarray(post.mean)))


class TestGramMatvecVJP:
    """The custom VJP (backward = plain-XLA row-block recompute) against
    dense float64 autodiff."""

    @pytest.mark.parametrize("name", ["rbf", "matern15", "rbf_white"])
    def test_grads_match_dense_f64(self, rng, name):
        n, m, d, r = 48, 40, 3, 2
        x1 = jnp.asarray(rng.uniform(-3, 3, (n, d)))
        x2 = jnp.asarray(rng.uniform(-3, 3, (m, d)))
        v = jnp.asarray(rng.standard_normal((m, r)))
        w = jnp.asarray(rng.standard_normal((n, r)))
        kern, p = KERNELS[name]
        p = _f64(p)

        def loss_mv(p, x1, x2, v):
            return jnp.sum(ops.gram_matvec(kern, p, x1, x2, v) * w)

        def loss_dense(p, x1, x2, v):
            return jnp.sum((ops.gram(kern, p, x1, x2) @ v) * w)

        g1 = jax.grad(loss_mv, argnums=(0, 1, 2, 3))(p, x1, x2, v)
        g2 = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(p, x1, x2, v)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12),
            g1, g2,
        )

    def test_fused_forward_interpret_grads(self, rng):
        """The fused forward (interpreted) composes with the same backward;
        f32, so the tolerance is f32's."""
        n = 70
        x = jnp.asarray(_x(rng, n, 2))
        v = jnp.asarray(rng.standard_normal((n, 2)).astype(np.float32))
        w = jnp.asarray(rng.standard_normal((n, 2)).astype(np.float32))
        k, p = _kernel("rbf")

        def loss(p, x, v, interpret):
            out = ops.gram_matvec(k, p, x, None, v, interpret=interpret,
                                  use_pallas=interpret)
            return jnp.sum(out * w)

        g1 = jax.grad(loss, argnums=(0, 1, 2))(p, x, v, True)
        g2 = jax.grad(loss, argnums=(0, 1, 2))(p, x, v, False)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4),
            g1, g2,
        )

    def test_grads_match_xla(self, rng):
        n, m, d, r = 48, 40, 3, 2
        x1 = jnp.asarray(rng.uniform(-3, 3, (n, d)))
        x2 = jnp.asarray(rng.uniform(-3, 3, (m, d)))
        v = jnp.asarray(rng.standard_normal((m, r)))
        w = jnp.asarray(rng.standard_normal((n, r)))
        kern = ops.RBF()
        p = {"sigma": jnp.asarray(1.2), "lengthscale": jnp.asarray(0.9)}

        def loss_mv(p, x1, x2, v):
            return jnp.sum(ops.gram_matvec(kern, p, x1, x2, v) * w)

        def loss_xla(p, x1, x2, v):
            return jnp.sum((ops.gram(kern, p, x1, x2) @ v) * w)

        assert np.isclose(float(loss_mv(p, x1, x2, v)), float(loss_xla(p, x1, x2, v)))
        g1 = jax.grad(loss_mv, argnums=(0, 1, 2, 3))(p, x1, x2, v)
        g2 = jax.grad(loss_xla, argnums=(0, 1, 2, 3))(p, x1, x2, v)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10),
            g1, g2,
        )

    def test_same_set_with_white(self, rng):
        n, d = 40, 2
        x = jnp.asarray(rng.uniform(-3, 3, (n, d)))
        v = jnp.asarray(rng.standard_normal(n))
        w = jnp.asarray(rng.standard_normal(n))
        kern = ops.RBF() + ops.White()
        p = (
            {"sigma": jnp.asarray(1.0), "lengthscale": jnp.asarray(1.1)},
            {"amplitude": jnp.asarray(0.5)},
        )

        def lp(p):
            return jnp.sum(ops.gram_matvec(kern, p, x, None, v) * w)

        def lx(p):
            return jnp.sum((ops.gram(kern, p, x) @ v) * w)

        np.testing.assert_allclose(float(lp(p)), float(lx(p)), rtol=1e-6)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12),
            jax.grad(lp)(p),
            jax.grad(lx)(p),
        )

    def test_cg_lml_quadratic_grad_matches_dense(self, rng):
        """jax.grad through a CG objective using the matrix-free matvec
        matches the dense path."""
        from gaussian_process_tpu.linalg.cg import cg_solve_grad

        n, d = 200, 3
        x = jnp.asarray(rng.uniform(-3, 3, (n, d)))
        y = jnp.asarray(rng.standard_normal(n))
        kern = ops.RBF()
        noise = 1e-2

        def mvf(p, v):
            return ops.gram_matvec(kern, p, x, None, v) + noise * v

        def quad_cg(p):
            return 0.5 * jnp.dot(y, cg_solve_grad(mvf, 1e-12, 2000, p, y))

        def quad_dense(p):
            Km = ops.gram(kern, p, x) + noise * jnp.eye(n, dtype=jnp.float64)
            return 0.5 * jnp.dot(y, jnp.linalg.solve(Km, y))

        p = {"sigma": jnp.asarray(1.1), "lengthscale": jnp.asarray(0.8)}
        np.testing.assert_allclose(float(quad_cg(p)), float(quad_dense(p)), rtol=1e-8)
        g1, g2 = jax.grad(quad_cg)(p), jax.grad(quad_dense)(p)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6), g1, g2
        )


@pytest.mark.gpu
def test_fused_compiled_on_gpu_matches_xla(gpu, rng):
    """The kernel as Triton compiles it for the card (no interpret mode)."""
    k, p = _kernel("matern15")
    a = _x(rng, 1000, 4)
    v = jnp.asarray(rng.standard_normal((1000, 16)).astype(np.float32))
    assert ops.matvec_path(k, a, 16) == "fused"
    got = ops.gram_matvec(k, p, a, None, v)
    assert _rel(got, _dense(k, p, a, None, v)) < 2e-5
