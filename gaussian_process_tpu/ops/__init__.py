"""Kernel-matrix construction and matrix-free matvec primitives."""

from gaussian_process_tpu.ops.distance import sqdist, absdist
from gaussian_process_tpu.ops.kernels import (
    RBF,
    Linear,
    Matern,
    Periodic,
    DecayedPeriodic,
    RationalQuadratic,
    White,
    Sum,
    Product,
    Scaled,
    gram,
    gram_diag,
    co2_kernel,
    co2_params_from_vector,
    co2_vector_from_params,
)
from gaussian_process_tpu.ops.matvec import gram_matvec, matvec_path, xla_matvec

__all__ = [
    "sqdist",
    "absdist",
    "RBF",
    "Linear",
    "Matern",
    "Periodic",
    "DecayedPeriodic",
    "RationalQuadratic",
    "White",
    "Sum",
    "Product",
    "Scaled",
    "gram",
    "gram_diag",
    "co2_kernel",
    "co2_params_from_vector",
    "co2_vector_from_params",
    "gram_matvec",
    "matvec_path",
    "xla_matvec",
]
