"""Fused kernel matvec K(x1, x2) @ v for NVIDIA GPUs (Pallas, Triton route).

Each program owns one (block_m, block_r) tile of the output and loops over
the columns of K in steps of ``block_n``. Per step it rebuilds the
(block_m, block_n) kernel tile in registers from the inputs, multiplies it
into the accumulator with a tensor-core ``pl.dot``, and drops it. K never
reaches device memory: a matvec reads O((n + m) d + m r) bytes per row
block instead of writing and re-reading the n * m kernel entries.

Squared distances are sums of squared coordinate differences taken one
input dimension at a time (no ||a||^2 + ||b||^2 - 2ab expansion, so no
cancellation), which is why inputs are stored transposed as (d, n) and
why ``d`` is capped at :data:`MAX_D`. Hyperparameters arrive as a flat
vector, so one compiled program serves every parameter value.

Only the forward product lives here; ``ops.matvec`` wraps it with the
plain-XLA backward pass and decides when it runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from gaussian_process_tpu.ops import kernels as _k

# The difference loop is unrolled over input dimensions, so the program
# grows with d; wider inputs take the XLA matvec.
MAX_D = 32

# Tile-times-V product: three TF32 tensor-core passes (hi*hi + hi*lo +
# lo*hi). Relative error ~1e-6, well inside the 2e-5 matvec budget, at a
# fraction of the cost of FP32 FMA. The CPU interpreter has no TF32, so
# interpret mode multiplies in full FP32.
DOT_PRECISION = lax.DotAlgorithmPreset.TF32_TF32_F32_X3
_INTERPRET_PRECISION = lax.DotAlgorithmPreset.F32_F32_F32


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_matvec(
    kernel: _k.Kernel,
    params: _k.Params,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    v: jnp.ndarray,
    *,
    block_m: int = 64,
    block_n: int = 64,
    interpret: bool = False,
) -> jnp.ndarray:
    """K(x1, x2) @ v for a stationary, White-free kernel; v is (m, r).

    Computes in float32 whatever the input dtype and returns v's dtype.
    Callers go through :func:`gaussian_process_tpu.ops.matvec.gram_matvec`,
    which splits White off, picks this path or the XLA one, and supplies
    gradients. The default 64 x 64 tile with 4 warps was the fastest of
    six shapes measured on an H100 at n=102400, r=16 (PERF.md).
    """
    if not _k.is_stationary(kernel):
        raise ValueError("the fused matvec supports stationary kernels only")
    x1 = _k._dist._as_2d(x1)
    x2 = _k._dist._as_2d(x2)
    n, d = x1.shape
    m, r = v.shape
    if d > MAX_D:
        raise ValueError(f"the fused matvec supports d <= {MAX_D}, got {d}")
    # Triton tiles are powers of two, and a dot operand needs every
    # dimension >= 16; wide RHS are split over the grid's second axis
    bm, bn = block_m, block_n
    br = min(max(16, _next_pow2(r)), 64)
    n_pad, m_pad, r_pad = _round_up(n, bm), _round_up(m, bn), _round_up(r, br)

    f32 = jnp.float32
    # center for f32 accuracy: distances are shift-invariant
    center = lax.stop_gradient(jnp.mean(x1, axis=0, keepdims=True))
    x1t = jnp.pad((x1 - center).astype(f32), ((0, n_pad - n), (0, 0))).T
    x2t = jnp.pad((x2 - center).astype(f32), ((0, m_pad - m), (0, 0))).T
    # zero rows of v make the padded columns of K inert
    vp = jnp.pad(v.astype(f32), ((0, m_pad - m), (0, r_pad - r)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    pvec = jnp.stack([jnp.asarray(leaf, f32) for leaf in leaves])

    want_l2 = _k.needs_l2(kernel)
    prec = _INTERPRET_PRECISION if interpret else DOT_PRECISION
    n_leaves = len(leaves)

    def kern(p_ref, x1t_ref, x2t_ref, v_ref, o_ref):
        i = pl.program_id(0)
        j = pl.program_id(1)
        params = jax.tree_util.tree_unflatten(
            treedef, [p_ref[k] for k in range(n_leaves)]
        )
        rows = pl.ds(i * bm, bm)
        a = [x1t_ref[k, rows] for k in range(d)]

        def body(c, acc):
            cols = pl.ds(c * bn, bn)
            sq = jnp.zeros((bm, bn), jnp.float32)
            for k in range(d):
                diff = a[k][:, None] - x2t_ref[k, cols][None, :]
                sq = sq + diff * diff
            l2 = jnp.sqrt(sq) if want_l2 else None
            tile = _k.eval_from_distances(kernel, params, sq, l2)
            vt = v_ref[cols, pl.ds(j * br, br)]
            return acc + pl.dot(tile, vt, precision=prec)

        o_ref[...] = lax.fori_loop(
            0, m_pad // bn, body, jnp.zeros((bm, br), jnp.float32)
        )

    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n_pad, r_pad), jnp.float32),
        grid=(n_pad // bm, r_pad // br),
        out_specs=pl.BlockSpec((bm, br), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4),
        interpret=interpret,
        name="fused_kernel_matvec",
    )(pvec, x1t, x2t, vp)
    return out[:n, :r].astype(v.dtype)
