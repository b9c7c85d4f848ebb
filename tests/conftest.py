"""Test harness configuration.

Runs everything on CPU with an emulated 8-device mesh
(``--xla_force_host_platform_device_count=8``) and float64 enabled, so:
- parity tests compare against float64 NumPy oracles transliterated from the
  reference scripts (SURVEY.md sec. 4, strategy item 3);
- distributed tests exercise real shardings/collectives without GPUs
  (SURVEY.md sec. 4, strategy item 4).

Tests that need a GPU carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them here; on a GPU machine run them with
``python -m pytest tests/ -m gpu -p no:xdist`` without this CPU override
(``GP_TESTS_ON_GPU=1``).

Must run before ``import jax`` anywhere in the test process.
"""

import os

# XLA_FLAGS is read at CPU-backend init, so setting it here works as long as
# no backend has been touched yet.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("GP_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips the test unless JAX sees a GPU. Decided when the test runs,
    never at import or collection time, so every pytest-xdist worker
    collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]


# ---------------------------------------------------------------- slow tier
# The full suite is ~7 minutes on a 2-core CI box; `-m "not slow"` keeps a
# quick-iteration tier (SURVEY.md §4; VERDICT r2 item 9). Slow = whole
# heavyweight integration modules plus individual tests measured >= ~4 s
# (dominated by XLA compiles of large programs, not by assertions — the
# fast tier still covers every feature through smaller configs).
_SLOW_FILES = {
    "test_large_scale.py",  # SLQ/Hutchinson matrix-free LML vs exact
    "test_multihost.py",  # multi-process DCN loopback (spawns workers)
    "test_parallel_multiclass.py",  # class-sharded Newton vs single-chip
    "test_co2_full.py",  # reference-scale 4x10x500 CO2 BO
    "test_distributed_nystrom_cg.py",  # n=8192 ill-conditioned dist CG
}
_SLOW_TESTS = {
    "test_matches_cholesky_path",
    "test_chunking_invariance",
    "test_posterior_mean_cg_matches_chol",
    "test_posterior_cg_nystrom_matches_cholesky",
    "test_beats_jacobi_and_agrees",
    "test_vmap_grad_mixed_ok_and_retry",
    "test_grad_matches_plain_cholesky",
    "test_grad_after_retry_is_finite",
    "test_grad_with_initial_jitter_under_jit",
    "test_surrogate_compiles_once_per_bucket",
    "test_padded_posterior_matches_unpadded",
    "test_jax_grad_matches_analytic_rbf_lengthscale",
    "test_all_acquisitions_improve",
    "test_co2_style_surrogate_params_fn",
    "test_grads_match_xla",
    "test_cg_lml_quadratic_grad_matches_dense",
    "test_same_set_with_white",
    "test_plots_write_files",
    "test_mauna_loa_book_theta_lml_anchor",
    "test_checkpoint_resume_mid_newton",
    "test_arbitrary_n_not_stride60",
    "test_mode_matches_full_system_oracle",
    "test_sharded_lml_integration",
    "test_composite_kernel_with_white",
    "test_arbitrary_n_with_white_kernel",
    "test_distributed_posterior_n63",
    "test_matches_single_chip_posterior",
    "test_solve_vector_and_matrix_rhs",
    "test_solve_config_supplies_noise",
    "test_sample_shapes",
    "test_matches_functional_posterior",
    "test_regressor_cg_solver_matches_cholesky",
    "test_larger_problem",
    "test_matches_single_device",
    "test_lml_batch_matches_serial",
    "test_apply_matches_dense_inverse",
    "test_matches_stock_multi_panel",
    "test_optimize_improves_lml",
    "test_gradient_ascent_config",
    "test_mean_and_var_match_dense",
    "test_safe_cholesky_routes_through_blocked",
    "test_bo_config",
    "test_leftlook_matches_stock",
    "test_distributed_cg_n63",
    "test_posterior_samples_contract_at_train_points",
    "test_posterior_mean_matches_cholesky",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = item.name.split("[")[0]
        if item.path.name in _SLOW_FILES or name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
