"""Matrix-free kernel matvec K(x1, x2) @ v — the one place that picks how
it runs.

Every CG solver in the package (regression, binary and multiclass Laplace,
large-scale training, the distributed ring matvec) multiplies by K through
:func:`gram_matvec`, and :func:`matvec_path` alone decides the route:

- ``"fused"``: the Pallas/Triton kernel in ``ops.pallas.kernel_matvec``,
  which never writes K to device memory. Chosen on a GPU backend for a
  stationary kernel on float32 inputs with d <= ``MAX_D`` and at most
  :data:`FUSED_MAX_R` right-hand sides.
- ``"xla"``: :func:`xla_matvec`, a ``lax.map`` over row blocks of x1 that
  builds one (block, m) slab of K at a time, so memory stays O(block * m)
  instead of O(n * m). Everything else takes this path, including the CPU
  where the tests run.

The fused kernel runs interpreted only when a caller passes
``interpret=True``. Gradients of either route come from one custom VJP
whose backward pass recomputes K row block by row block in plain XLA and
pulls the cotangent back through each block with ``jax.vjp``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.ops.pallas import kernel_matvec as _fused

_HI = lax.Precision.HIGHEST
# Widest RHS the fused kernel takes. It rebuilds every K tile once per 64
# columns of v, while the XLA path writes each K slab once and hands the
# product to cuBLAS; on an H100 at n=102400 the fused kernel wins up to
# r=128 and loses from r=256 on (PERF.md).
FUSED_MAX_R = 128
# Elements of K held at once by one row block of the XLA path (512 MB f32).
_SLAB_ELEMS = 1 << 27


def matvec_path(
    kernel: _k.Kernel,
    x: jnp.ndarray,
    r: int = 1,
    *,
    use_pallas: Optional[bool] = None,
    interpret: bool = False,
) -> str:
    """``"fused"``, ``"fused_interpret"`` or ``"xla"`` for K(x, .) @ v
    with ``r`` right-hand sides.

    ``kernel`` is the White-free kernel that reaches the product.
    ``use_pallas=None`` picks the fused kernel on a GPU backend when it
    applies and ``r <= FUSED_MAX_R``; ``True`` demands it (ValueError if
    it cannot apply); ``False`` forces the XLA route.
    """
    x = _k._dist._as_2d(x)
    fits = (
        _k.is_stationary(kernel)
        and x.dtype == jnp.float32
        and x.shape[1] <= _fused.MAX_D
    )
    if use_pallas is None:
        use_pallas = fits and r <= FUSED_MAX_R and (
            interpret or jax.default_backend() == "gpu"
        )
    if not use_pallas:
        return "xla"
    if not fits:
        raise ValueError(
            "the fused matvec needs a stationary kernel, float32 inputs and "
            f"d <= {_fused.MAX_D}"
        )
    return "fused_interpret" if interpret else "fused"


def gram_matvec(
    kernel: _k.Kernel,
    params: _k.Params,
    x1: jnp.ndarray,
    x2: Optional[jnp.ndarray],
    v: jnp.ndarray,
    *,
    use_pallas: Optional[bool] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """K(x1, x2) @ v without materialising K; differentiable in every
    argument.

    ``v`` is (m,) or (m, r). ``x2=None`` means the same set, including the
    White diagonal (added as ``white * v``). See :func:`matvec_path` for
    ``use_pallas`` and ``interpret``.
    """
    vec = v.ndim == 1
    vv = v[:, None] if vec else v
    x1 = _k._dist._as_2d(x1)
    white = None
    if x2 is None:
        kernel, params, white = _k.split_white(kernel, params)
        x2 = x1
    else:
        x2 = _k._dist._as_2d(x2)
    if kernel is None:  # pure White
        out = white * vv
    else:
        path = matvec_path(
            kernel, x1, vv.shape[1], use_pallas=use_pallas, interpret=interpret
        )
        out = _matvec(kernel, path, params, x1, x2, vv)
        if white is not None:
            out = out + white * vv
    return out[:, 0] if vec else out


def _row_block(n: int, m: int) -> int:
    return max(1, min(n, _SLAB_ELEMS // max(m, 1)))


def _row_blocks(x: jnp.ndarray, block: int) -> jnp.ndarray:
    nb = -(-x.shape[0] // block)
    x = jnp.pad(x, ((0, nb * block - x.shape[0]), (0, 0)))
    return x.reshape(nb, block, x.shape[1])


def xla_matvec(kernel, params, x1, x2, v, *, block: Optional[int] = None):
    """K(x1, x2) @ v in plain XLA, one (block, m) slab of K at a time; v is
    (m, r). The reference the fused kernel is checked against."""
    n, m = x1.shape[0], x2.shape[0]
    block = block or _row_block(n, m)
    out = lax.map(
        lambda a: jnp.dot(_k.gram(kernel, params, a, x2), v, precision=_HI),
        _row_blocks(x1, block),
    )
    return out.reshape(-1, v.shape[1])[:n]


def _forward(kernel, path, params, x1, x2, v):
    if path == "xla":
        return xla_matvec(kernel, params, x1, x2, v)
    return _fused.fused_matvec(
        kernel, params, x1, x2, v, interpret=path == "fused_interpret"
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _matvec(kernel, path, params, x1, x2, v):
    return _forward(kernel, path, params, x1, x2, v)


def _matvec_fwd(kernel, path, params, x1, x2, v):
    return _forward(kernel, path, params, x1, x2, v), (params, x1, x2, v)


def _matvec_bwd(kernel, path, res, ct):
    """For L = <ct, K(x1, x2) v>: d_v = K(x2, x1) ct (the same forward with
    the sets swapped, since k(a, b) = k(b, a)); d_params, d_x1 and d_x2
    from one scan over row blocks of x1 that rebuilds each slab of K and
    pulls dK = ct_blk v^T back through it."""
    params, x1, x2, v = res
    d_v = _forward(kernel, path, params, x2, x1, ct).astype(v.dtype)
    n, m = x1.shape[0], x2.shape[0]
    block = _row_block(n, m)

    def body(carry, blk):
        d_p, d_x2 = carry
        a, c = blk
        _, pull = jax.vjp(lambda p, a, b: _k.gram(kernel, p, a, b), params, a, x2)
        g_p, g_a, g_b = pull(jnp.dot(c, v.T, precision=_HI))
        d_p = jax.tree_util.tree_map(jnp.add, d_p, g_p)
        return (d_p, d_x2 + g_b), g_a

    zeros = (jax.tree_util.tree_map(jnp.zeros_like, params), jnp.zeros_like(x2))
    (d_p, d_x2), d_x1 = lax.scan(
        body, zeros, (_row_blocks(x1, block), _row_blocks(ct.astype(v.dtype), block))
    )
    d_x1 = d_x1.reshape(-1, x1.shape[1])[:n]
    return d_p, d_x1.astype(x1.dtype), d_x2.astype(x2.dtype), d_v


_matvec.defvjp(_matvec_fwd, _matvec_bwd)
