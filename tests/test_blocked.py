"""Left-looking blocked Cholesky.

The production factorization above ``MIN_BLOCKED_N`` (wired through
``linalg.safe_cholesky`` / ``gp.posterior``); correctness here is against
NumPy f64 oracles (SURVEY.md sec. 4 item 2). The threshold constant is
monkeypatched down so the multi-panel code path runs at CPU-friendly sizes —
the panel loop is shape-generic, so n=608/block=128 exercises exactly the
code that runs at n=8192/block=1024 on the GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_tpu.linalg import blocked
from gaussian_process_tpu.linalg.cholesky import safe_cholesky


def _spd(rng, n, jitter=1e-3):
    x = rng.uniform(-5, 5, (n, 4))
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * sq) + jitter * np.eye(n)


@pytest.fixture
def small_threshold(monkeypatch):
    """Lower MIN_BLOCKED_N so CPU-friendly sizes can take the blocked path.

    Dispatch condition is n > max(block, MIN_BLOCKED_N): with this patch the
    blocked path needs n > block (128 in most tests here; DEFAULT_BLOCK for
    callers that don't pass one) — not simply n >= 256."""
    monkeypatch.setattr(blocked, "MIN_BLOCKED_N", 256)


class TestBlockedCholesky:
    def test_matches_stock_multi_panel(self, rng, small_threshold):
        n = 608  # 5 panels at block=128, n % block != 0 (ragged tail panel)
        K = _spd(rng, n)
        L = np.asarray(
            blocked.blocked_cholesky(jnp.asarray(K), block=128)
        )
        L0 = np.linalg.cholesky(K)
        np.testing.assert_allclose(L, L0, rtol=1e-8, atol=1e-9)
        assert np.allclose(np.triu(L, 1), 0.0)

    def test_small_n_delegates_to_stock(self, rng):
        K = _spd(rng, 64)
        L = np.asarray(blocked.blocked_cholesky(jnp.asarray(K)))
        np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-10)

    def test_nan_on_indefinite(self, rng, small_threshold):
        n = 384
        K = _spd(rng, n)
        K[n - 1, n - 1] = -1e3  # indefinite trailing block
        L = np.asarray(
            blocked.blocked_cholesky(jnp.asarray(K), block=128)
        )
        assert np.isnan(np.diag(L)).any()

    @pytest.mark.parametrize("n,block", [(608, 128), (1184, 256), (300, 128)])
    def test_leftlook_matches_stock(self, rng, small_threshold, n, block):
        """Left-looking tiled variant: identical semantics to stock/blocked
        (incl. ragged tail panels and n < block delegation)."""
        K = _spd(rng, n)
        L = np.asarray(blocked.blocked_cholesky(jnp.asarray(K), block=block))
        np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=1e-8, atol=1e-9)
        assert np.allclose(np.triu(L, 1), 0.0)

    def test_leftlook_nan_on_indefinite_leading_block(self, rng, small_threshold):
        """A NaN from an indefinite EARLY panel must propagate to the factor
        diagonal (safe_cholesky's check) through the left-looking updates."""
        n = 384
        K = _spd(rng, n)
        K[10, 10] = -1e3  # indefinite inside the first panel
        L = np.asarray(blocked.blocked_cholesky(jnp.asarray(K), block=128))
        assert np.isnan(np.diag(L)).any()

    def test_safe_cholesky_routes_through_blocked(self, rng, small_threshold,
                                                  monkeypatch):
        """safe_cholesky above the (patched) threshold must dispatch into the
        blocked factorization and produce the same factor. The dispatcher is
        semantics-invisible, so the numeric check alone would also pass on a
        silent fallback to stock — a spy asserts blocked_cholesky really ran
        (ADVICE.md round 2). n > DEFAULT_BLOCK so the default-block call
        takes the multi-panel branch, with a ragged tail panel."""
        n = blocked.DEFAULT_BLOCK + 160
        K = _spd(rng, n)
        called = []
        real = blocked.blocked_cholesky

        def spy(K, **kw):
            called.append(K.shape)
            return real(K, **kw)

        monkeypatch.setattr(blocked, "blocked_cholesky", spy)
        res = safe_cholesky(jnp.asarray(K))
        # >= 1: the happy-path factorization plus the (traced-only) retry body
        assert called and all(s == (n, n) for s in called), (
            "dispatcher did not route through blocked"
        )
        assert bool(res.ok)
        np.testing.assert_allclose(
            np.asarray(res.factor), np.linalg.cholesky(K), rtol=1e-8, atol=1e-9
        )
