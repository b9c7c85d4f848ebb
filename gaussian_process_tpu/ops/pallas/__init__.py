"""Pallas GPU kernels (Triton route)."""

from gaussian_process_tpu.ops.pallas.kernel_matvec import fused_matvec

__all__ = ["fused_matvec"]
