"""Unit tests: kernel functions vs float64 NumPy oracles + property tests.

SURVEY.md sec. 4 strategy item 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_tpu import ops
import oracles


def _x(rng, n, d):
    return rng.uniform(-5, 5, size=(n, d))


class TestRBF:
    def test_matches_oracle(self, rng):
        a, b = _x(rng, 17, 3), _x(rng, 9, 3)
        k = ops.RBF()
        p = {"sigma": jnp.asarray(1.7), "lengthscale": jnp.asarray(0.6)}
        got = ops.gram(k, p, a, b)
        want = oracles.rbf(a, b, 1.7, 0.6)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_1d_inputs_promoted(self, rng):
        a = rng.uniform(-5, 5, size=(8,))
        k = ops.RBF()
        p = k.init_params()
        got = ops.gram(k, p, a)
        want = oracles.rbf(a[:, None], a[:, None], 1.0, 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_diag_is_sigma_sq(self, rng):
        a = _x(rng, 11, 2)
        p = {"sigma": jnp.asarray(2.0), "lengthscale": jnp.asarray(1.0)}
        d = ops.gram_diag(ops.RBF(), p, a)
        np.testing.assert_allclose(d, 4.0 * np.ones(11))

    def test_symmetry_and_psd(self, rng):
        a = _x(rng, 30, 4)
        K = np.asarray(ops.gram(ops.RBF(), ops.RBF().init_params(), a))
        np.testing.assert_allclose(K, K.T, atol=1e-12)
        w = np.linalg.eigvalsh(K + 1e-10 * np.eye(30))
        assert (w > 0).all()


class TestLinear:
    def test_matches_oracle(self, rng):
        a, b = _x(rng, 7, 2), _x(rng, 5, 2)
        p = {"offset": jnp.asarray(1.3)}
        got = ops.gram(ops.Linear(), p, a, b)
        np.testing.assert_allclose(got, oracles.linear(a, b, 1.3), rtol=1e-10)


class TestMatern:
    @staticmethod
    def _oracle(a, b, nu, sigma, ell):
        d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
        r = d / ell
        if nu == 0.5:
            body = np.exp(-r)
        elif nu == 1.5:
            s = np.sqrt(3.0) * r
            body = (1.0 + s) * np.exp(-s)
        else:
            s = np.sqrt(5.0) * r
            body = (1.0 + s + s * s / 3.0) * np.exp(-s)
        return sigma**2 * body

    @pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
    def test_matches_oracle(self, rng, nu):
        a, b = _x(rng, 13, 3), _x(rng, 7, 3)
        p = {"sigma": jnp.asarray(1.4), "lengthscale": jnp.asarray(0.8)}
        got = ops.gram(ops.Matern(nu=nu), p, a, b)
        np.testing.assert_allclose(got, self._oracle(a, b, nu, 1.4, 0.8), rtol=1e-9)

    def test_diag_and_psd(self, rng):
        a = _x(rng, 21, 2)
        k = ops.Matern(nu=1.5)
        p = k.init_params()
        d = ops.gram_diag(k, p, a)
        np.testing.assert_allclose(d, np.ones(21))
        K = np.asarray(ops.gram(k, p, a))
        np.testing.assert_allclose(K, K.T, atol=1e-12)
        w = np.linalg.eigvalsh(K + 1e-10 * np.eye(21))
        assert (w > -1e-8).all()

    def test_invalid_nu_rejected(self):
        with pytest.raises(ValueError):
            ops.Matern(nu=2.0)


class TestPeriodic:
    def test_matches_oracle(self, rng):
        a, b = _x(rng, 12, 1), _x(rng, 12, 1)
        p = {"period": jnp.asarray(2.0), "lengthscale": jnp.asarray(0.7)}
        got = ops.gram(ops.Periodic(), p, a, b, method="diff")
        np.testing.assert_allclose(
            got, oracles.periodic(a, b, 2.0, 0.7), rtol=1e-9, atol=1e-11
        )


class TestCO2Composite:
    BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])

    def test_same_set_includes_white(self, rng):
        x = np.sort(rng.uniform(1958, 2000, size=(25, 1)), axis=0)
        k = ops.co2_kernel()
        p = ops.co2_params_from_vector(self.BOOK)
        got = ops.gram(k, p, x)
        want = oracles.co2_composite(x, x, self.BOOK, same=True)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)

    def test_cross_set_excludes_white(self, rng):
        x1 = rng.uniform(1958, 2000, size=(10, 1))
        x2 = rng.uniform(2000, 2020, size=(6, 1))
        k = ops.co2_kernel()
        p = ops.co2_params_from_vector(self.BOOK)
        got = ops.gram(k, p, x1, x2)
        want = oracles.co2_composite(x1, x2, self.BOOK, same=False)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)

    def test_vector_roundtrip(self):
        p = ops.co2_params_from_vector(self.BOOK)
        back = ops.co2_vector_from_params(p)
        np.testing.assert_allclose(back, self.BOOK)

    def test_multid_inputs(self, rng):
        a, b = _x(rng, 9, 11), _x(rng, 9, 11)
        k = ops.co2_kernel()
        p = ops.co2_params_from_vector(self.BOOK)
        got = ops.gram(k, p, a, b)
        want = oracles.co2_composite(a, b, self.BOOK, same=False)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


class TestAlgebra:
    def test_sum_product_operators(self, rng):
        a = _x(rng, 6, 2)
        k = ops.RBF() + ops.White()
        p = (ops.RBF().init_params(), ops.White().init_params())
        got = ops.gram(k, p, a)
        want = oracles.rbf(a, a, 1.0, 1.0) + np.eye(6)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

        k2 = ops.Product(children=(ops.RBF(), ops.Periodic()))
        p2 = k2.init_params()
        got2 = ops.gram(k2, p2, a)
        d = np.sqrt(((a[:, None, :] - a[None, :, :]) ** 2).sum(-1))
        want2 = oracles.rbf(a, a, 1.0, 1.0) * np.exp(
            -2 * np.sin(np.pi * d) ** 2
        )
        np.testing.assert_allclose(got2, want2, rtol=1e-9, atol=1e-11)

    def test_scaled(self, rng):
        a = _x(rng, 6, 1)
        k = ops.Scaled(base=ops.Periodic())
        p = {"amplitude": jnp.asarray(3.0), "base": ops.Periodic().init_params()}
        got = ops.gram(k, p, a, method="diff")
        want = 9.0 * oracles.periodic(a, a, 1.0, 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


class TestDistance:
    @pytest.mark.parametrize("method", ["dot", "diff"])
    def test_sqdist(self, rng, method):
        a, b = _x(rng, 13, 5), _x(rng, 8, 5)
        got = ops.sqdist(a, b, method=method)
        want = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)

    def test_absdist_zero_diag(self, rng):
        a = _x(rng, 10, 3)
        d = np.asarray(ops.absdist(a, a))
        np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-6)


class TestMatmulPrecision:
    """A default-precision f32 matmul runs in TF32 on an H100 (~3e-4
    relative error measured on a 2048 x 2048 product), an error that
    exceeds the GP jitter scale and corrupts kernel matrices. CPU runs at
    full precision either way, so correctness tests cannot catch a
    regression — these tests pin precision=HIGHEST in the traced program."""

    @staticmethod
    def _dot_precisions(fn, *args):
        import jax
        from jax import lax

        precisions = []

        def walk(jaxpr):
            for eqn in jaxpr.eqns:
                if eqn.primitive.name == "dot_general":
                    precisions.append(eqn.params.get("precision"))
                for v in eqn.params.values():
                    if hasattr(v, "jaxpr"):
                        walk(v.jaxpr)
        walk(jax.make_jaxpr(fn)(*args).jaxpr)
        return precisions

    def test_sqdist_dot_uses_highest(self, rng):
        from jax import lax

        a = _x(rng, 8, 3)
        precs = self._dot_precisions(lambda a: ops.sqdist(a, a), a)
        assert precs, "expected a dot_general in sqdist(method='dot')"
        assert all(
            p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST) for p in precs
        ), precs

    def test_linear_gram_uses_highest(self, rng):
        from jax import lax

        a = _x(rng, 8, 3)
        k = ops.Linear()
        p = k.init_params()
        precs = self._dot_precisions(lambda a: ops.gram(k, p, a), a)
        assert precs and all(
            pr == (lax.Precision.HIGHEST, lax.Precision.HIGHEST) for pr in precs
        ), precs
