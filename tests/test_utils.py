"""Tests for the auxiliary subsystems (SURVEY.md §5): datasets, logging,
checkpoint/resume, profiling, plotting."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_tpu import gp, ops
from gaussian_process_tpu.utils import checkpoint, datasets, plotting, profiling
from gaussian_process_tpu.utils.logging import JsonlLogger, read_jsonl


# ---------------------------------------------------------------- datasets


def test_sine_regression_shapes_and_determinism():
    f, xtr, ytr, xte = datasets.sine_regression(5, 100, seed=0)
    assert xtr.shape == (5, 1) and ytr.shape == (5,) and xte.shape == (100, 1)
    # fixed seed -> identical draw [SURVEY.md §7 RNG parity]
    _, xtr2, ytr2, _ = datasets.sine_regression(5, 100, seed=0)
    np.testing.assert_array_equal(xtr, xtr2)
    np.testing.assert_array_equal(ytr, ytr2)
    # noise is small: y ~= sin(0.9 x) [ref: GP_regression.py:58,66]
    np.testing.assert_allclose(ytr, f(xtr), atol=0.15)


def test_moons_binary_labels_and_split():
    Xtr, Xte, ytr, yte = datasets.moons_binary()
    assert set(np.unique(np.concatenate([ytr, yte]))) == {-1, 1}
    assert len(Xtr) == 60 and len(Xte) == 40  # 60/40 [ref: GP_binary_classification.py:160]
    # standardised features
    allX = np.concatenate([Xtr, Xte])
    np.testing.assert_allclose(allX.mean(0), 0.0, atol=1e-8)


def test_blobs_multiclass():
    Xtr, Xte, ytr, yte = datasets.blobs_multiclass()
    assert len(Xtr) == 60 and len(Xte) == 40  # [ref: GP_multi_classification.py:221]
    assert set(np.unique(np.concatenate([ytr, yte]))) == {0, 1, 2}


def test_mauna_loa_vendored():
    x, y, mean = datasets.mauna_loa()
    assert x.ndim == 2 and x.shape[1] == 1 and y.shape == (x.shape[0],)
    assert abs(y.mean()) < 1e-6  # mean-centered [ref: CO2_example.py:411-412]
    assert mean > 300  # CO2 ppm scale
    grid = datasets.mauna_loa_test_grid(x, years=20)
    assert grid.shape == (240, 1)  # 20 years monthly [ref: CO2_example.py:408]
    assert grid.min() > x.max()


def test_mauna_loa_is_real_keeling_record():
    """The vendored series is the real NOAA-anchored record, not the round-1
    synthetic curve: spot-check the famous first measurements and the known
    annual means (see data/make_mauna_loa.py provenance)."""
    x, y, mean = datasets.mauna_loa()
    t = x[:, 0]
    co2 = y + mean
    assert len(t) == 526  # monthly, Mar 1958 - Dec 2001
    # first Keeling measurement: March 1958 = 315.71 ppm
    np.testing.assert_allclose(co2[0], 315.71, atol=0.01)
    np.testing.assert_allclose(t[0], 1958 + 2.5 / 12, atol=1e-3)
    # NOAA annual means (1959, 1980, 2001)
    # 0.15 ppm tolerance: the reconstruction anchors the trend at mid-year,
    # so calendar-year averages differ from the NOAA annual means by the
    # trend's curvature (<0.1 ppm) — see make_mauna_loa.py provenance
    for year, ppm in [(1959, 315.98), (1980, 338.76), (2001, 371.32)]:
        sel = (t >= year) & (t < year + 1)
        assert sel.sum() == 12
        np.testing.assert_allclose(co2[sel].mean(), ppm, atol=0.15)
    # seasonal cycle ~6 ppm peak-to-trough, May max / Sep-Oct min
    one_year = co2[(t >= 1990) & (t < 1991)]
    assert 5.0 < one_year.max() - one_year.min() < 7.5
    assert int(np.argmax(one_year)) == 4  # May
    assert int(np.argmin(one_year)) in (8, 9)  # Sep/Oct


def test_mauna_loa_book_theta_lml_anchor():
    """The reference anchors its CO2 search to the GPML book hyperparameters'
    LML [ref: CO2_example.py:324,362-371]. On the vendored real series that
    anchor must be finite and bit-reproducible across runs (the parity
    surface the CO2 example prints)."""
    import jax.numpy as jnp

    from gaussian_process_tpu import gp, ops

    x, y, _ = datasets.mauna_loa()
    theta = jnp.asarray(
        [66.0, 67.0, 2.4, 90.0, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19]
    )
    kernel = ops.co2_kernel()
    params = ops.co2_params_from_vector(theta)
    lml1 = float(
        gp.log_marginal_likelihood(kernel, params, jnp.asarray(x), jnp.asarray(y),
                                   noise_variance=5e-4)
    )
    lml2 = float(
        gp.log_marginal_likelihood(kernel, params, jnp.asarray(x), jnp.asarray(y),
                                   noise_variance=5e-4)
    )
    assert np.isfinite(lml1)
    assert lml1 == lml2  # deterministic reduction order
    # f64 value recorded at vendoring time; the book kernel fits the real
    # series well (positive LML at n=526 with s=5e-4)
    assert abs(lml1 - 181.549) < 0.5


# ----------------------------------------------------------------- logging


def test_jsonl_logger_roundtrip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlLogger(path) as log:
        log.newton_step(1, 0.5)
        log.newton_step(2, jnp.float32(0.25))  # jax scalar must serialize
        log.bo_step(1, best_lml=-3.2, candidate=np.array([1.0, 2.0]))
    records = read_jsonl(path)
    assert [r["event"] for r in records] == ["newton_step", "newton_step", "bo_step"]
    assert records[1]["error"] == 0.25
    assert records[2]["candidate"] == [1.0, 2.0]
    assert all(r["rank"] == 0 for r in records)


# -------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_pytree(tmp_path):
    tree = {
        "theta": {"sigma": jnp.float32(1.5), "l": jnp.float32(0.7)},
        "alpha": jnp.arange(8, dtype=jnp.float32),
        "step": jnp.int32(3),
    }
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, tree)
    restored = checkpoint.restore(path, like=tree)
    assert float(restored["theta"]["sigma"]) == 1.5
    np.testing.assert_array_equal(np.asarray(restored["alpha"]), np.arange(8))
    assert restored["alpha"].dtype == np.float32


def test_checkpoint_steps_and_latest(tmp_path):
    root = str(tmp_path / "run")
    tree = {"x": jnp.zeros(3)}
    for s in (1, 5, 12):
        checkpoint.save(root, {"x": jnp.full(3, float(s))}, step=s)
    assert checkpoint.latest_step(root) == 12
    restored = checkpoint.restore(root, like=tree, step=checkpoint.latest_step(root))
    np.testing.assert_array_equal(np.asarray(restored["x"]), np.full(3, 12.0))


def test_checkpoint_resume_mid_newton(tmp_path):
    """Newton state checkpointed mid-run resumes to the same mode."""
    Xtr, _, ytr, _ = datasets.moons_binary()
    kernel = ops.RBF()
    params = kernel.init_params()
    X = jnp.asarray(Xtr, jnp.float32)
    y = jnp.asarray(ytr, jnp.float32)
    fit = gp.fit_binary(kernel, params, X, y)
    path = str(tmp_path / "newton")
    checkpoint.save(path, {"f": fit.f_mode})
    restored = checkpoint.restore(path, like={"f": fit.f_mode})
    np.testing.assert_allclose(np.asarray(restored["f"]), np.asarray(fit.f_mode), rtol=1e-6)
    # warm-starting from the checkpointed mode converges immediately
    refit = gp.fit_binary(kernel, params, X, y, f_init=jnp.asarray(restored["f"]))
    assert int(refit.iters) <= 2
    np.testing.assert_allclose(np.asarray(refit.f_mode), np.asarray(fit.f_mode), atol=1e-4)


def test_dataset_cache(tmp_path):
    path = str(tmp_path / "cache.npz")
    assert checkpoint.load_dataset_cache(path) is None
    X = np.random.default_rng(0).standard_normal((10, 2))
    checkpoint.save_dataset_cache(path, X=X, y=np.arange(10))
    out = checkpoint.load_dataset_cache(path)
    np.testing.assert_array_equal(out["X"], X)
    np.testing.assert_array_equal(out["y"], np.arange(10))


# --------------------------------------------------------------- profiling


def test_time_fn_excludes_compile():
    @jax.jit
    def f(x):
        return (x @ x.T).sum()

    x = jnp.ones((256, 256))
    stats = profiling.time_fn(f, x, warmup=1, iters=3)
    assert stats["iters"] == 3
    assert 0 < stats["min_s"] <= stats["mean_s"] < 5.0  # compiled call is fast


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper sets
    nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_persistent_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path, restore_cache_config):
    """Without the variable the cache lands in <checkout>/.jax_cache,
    whatever the working directory."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert profiling.enable_persistent_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_stopwatch_phases():
    sw = profiling.Stopwatch()
    with sw.phase("build"):
        pass
    with sw.phase("build"):
        pass
    with sw.phase("solve"):
        pass
    summary = sw.summary()
    assert summary["build"]["count"] == 2 and summary["solve"]["count"] == 1


# ---------------------------------------------------------------- plotting


def test_plots_write_files(tmp_path):
    f, xtr, ytr, xte = datasets.sine_regression(5, 50, seed=0)
    kernel = ops.RBF()
    params = kernel.init_params()
    post = gp.posterior(
        kernel, params,
        jnp.asarray(xtr, jnp.float32), jnp.asarray(ytr, jnp.float32),
        jnp.asarray(xte, jnp.float32), noise_variance=5e-4,
    )
    p1 = plotting.plot_gp_band(
        xte, np.asarray(post.mean), np.asarray(post.std),
        str(tmp_path / "band.png"), x_train=xtr, y_train=ytr, true_fn=f,
    )
    K = np.asarray(ops.gram(kernel, params, jnp.asarray(xtr, jnp.float32)))
    p2 = plotting.plot_kernel_matrix(K, str(tmp_path / "K.png"))
    p3 = plotting.plot_convergence([1.0, 0.1, 1e-3], str(tmp_path / "conv.png"))
    p4 = plotting.plot_bo_progress([-5.0, -3.0, -4.0], str(tmp_path / "bo.png"), best_line=-2.5)
    Xtr, Xte, ytr2, yte2 = datasets.moons_binary()
    p5 = plotting.plot_classification_2d(Xtr, ytr2, Xte, yte2, str(tmp_path / "cls.png"))
    for p in (p1, p2, p3, p4, p5):
        assert os.path.exists(p) and os.path.getsize(p) > 0
