"""Data-partitioned kernel-matrix construction (SURVEY.md C13).

X is sharded by rows over the ``data`` mesh axis; each chip builds its
block-row K[rows_local, :] with the same kernel algebra. The all-gather of X
is O(n d) bytes — negligible against the O(n^2 d / p) compute per chip.

No reference equivalent: the reference always materialises the full K on one
host [ref: GP_regression.py:126-128].
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.ops import matvec as _mv


def _local_block_row(kernel, params, x_local, x_full, row_offset, white_var, dist_method):
    """K[rows_local, :] including White's global-diagonal contribution."""
    Kb = _k.gram(kernel, params, x_local, x_full, method=dist_method)
    if white_var is not None:
        nl, n = Kb.shape
        rows = row_offset + lax.broadcasted_iota(jnp.int32, (nl, n), 0)
        cols = lax.broadcasted_iota(jnp.int32, (nl, n), 1)
        Kb = Kb + jnp.where(rows == cols, white_var, jnp.zeros((), Kb.dtype))
    return Kb


def sharded_gram(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    *,
    mesh: Mesh,
    axis: str = "data",
    dist_method: str = "dot",
) -> jnp.ndarray:
    """Full K(x, x) with block-rows computed in parallel across ``axis``.

    Returns K row-sharded over ``axis`` (a jax.Array spanning the mesh).
    x's leading dim must divide the axis size (see mesh.pad_to_multiple).
    """
    k_nw, p_nw, white_var = _k.split_white(kernel, params)

    def fn(x_local):
        p = lax.axis_size(axis)
        me = lax.axis_index(axis)
        x_full = lax.all_gather(x_local, axis, tiled=True)
        return _local_block_row(
            k_nw, p_nw, x_local, x_full, me * x_local.shape[0], white_var, dist_method
        )

    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
    )(x)


def ring_matvec(
    kernel: _k.Kernel,
    params: _k.Params,
    x: jnp.ndarray,
    v: jnp.ndarray,
    *,
    mesh: Mesh,
    axis: str = "data",
    block_fn=None,
) -> jnp.ndarray:
    """y = K(x, x) @ v with X and v row-sharded and K never materialised
    globally — the ring-attention communication pattern applied to kernel
    matvecs (SURVEY.md sec. 5, long-context row): each step computes the
    local (n/p, n/p) tile against the in-flight (x, v) block, then
    ``ppermute``s the block to the ring neighbour so compute and communication overlap.

    O(n^2/p) compute and O(n) communication per device; the full K (O(n^2))
    never exists anywhere. The local tile product defaults to
    ``ops.gram_matvec``; ``block_fn(x_local, xb, vb) -> tile @ vb``
    overrides it.
    """
    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    if block_fn is None:
        def block_fn(xl, xb, vb):
            return _mv.gram_matvec(k_nw, p_nw, xl, xb, vb)

    def fn(x_local, v_local):
        p = lax.axis_size(axis)
        perm = [(i, (i + 1) % p) for i in range(p)]

        def body(step, carry):
            xb, vb, acc = carry
            acc = acc + block_fn(x_local, xb, vb)
            xb = lax.ppermute(xb, axis, perm)
            vb = lax.ppermute(vb, axis, perm)
            return xb, vb, acc

        acc0 = jnp.zeros_like(v_local)
        _, _, acc = lax.fori_loop(0, p, body, (x_local, v_local, acc0))
        if white_var is not None:
            acc = acc + white_var * v_local
        return acc

    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
    )(x, v)
