"""Distributed LML training step — the full multi-chip hyperparameter-ascent
program (SURVEY.md C13+C14+C16 composed).

One ``shard_map`` over a ('restart', 'data') mesh:

- the candidate-params batch is sharded over ``restart`` (each restart group
  optimises its own hyperparameters — sharded search restarts, C16);
- X and y are row-sharded over ``data``; each chip builds its kernel
  block-row locally (C13), the block-rows ``all_gather`` over the interconnect into the
  replicated K each group factorises (exact-Cholesky path, C14);
- jax.value_and_grad runs *inside* the shard_map, so the backward pass's
  collectives (psum-scatter duals of the gathers) also ride the interconnect;
- the optax ascent update happens on-device; one jitted program per step.

The reference has no distributed anything; its serial analogue is the
Python re-build-everything ascent loop [ref: tune_hyperparms_regression.py:104-162].
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_process_tpu.linalg import cholesky as _chol
from gaussian_process_tpu.opt import gradient as _grad
from gaussian_process_tpu.ops import kernels as _k
from gaussian_process_tpu.parallel.kernel_blocks import _local_block_row


class TrainStepResult(NamedTuple):
    params: Any  # updated candidate batch (restart-sharded)
    opt_state: Any
    lml: jnp.ndarray  # (R,) per-restart LML before the update


def make_distributed_train_step(
    kernel: _k.Kernel,
    *,
    mesh: Mesh,
    noise_variance: float = 5e-4,
    learning_rate: float = 0.01,
    optimizer: str = "adam",
    transform: str = "log",
    data_axis: str = "data",
    restart_axis: str = "restart",
    dist_method: str = "dot",
):
    """Returns (step_fn, init_fn).

    ``init_fn(params_batch)`` -> opt_state batch.
    ``step_fn(params_batch, opt_state, x, y)`` -> TrainStepResult, where
    params_batch leaves have leading dim R (= restart axis size) and x/y are
    row-shardable over the data axis.
    """
    tx = optax.adam(learning_rate) if optimizer == "adam" else optax.sgd(learning_rate)
    to_opt = _grad.log_params if transform == "log" else (lambda p: p)
    from_opt = _grad.exp_params if transform == "log" else (lambda p: p)

    def _local_lml(opt_params, x_local, y_local):
        pp = from_opt(opt_params)
        k_nw, p_nw, white_var = _k.split_white(kernel, pp)
        x_full = lax.all_gather(x_local, data_axis, tiled=True)
        y_full = lax.all_gather(y_local, data_axis, tiled=True)
        me = lax.axis_index(data_axis)
        K_row = _local_block_row(
            k_nw, p_nw, x_local, x_full, me * x_local.shape[0], white_var, dist_method
        )
        K = lax.all_gather(K_row, data_axis, tiled=True)
        res = _chol.safe_cholesky(K, initial_jitter=noise_variance)
        alpha = _chol.cholesky_solve(res.factor, y_full)
        n = y_full.shape[0]
        return (
            -0.5 * jnp.dot(y_full, alpha)
            - jnp.sum(jnp.log(jnp.diagonal(res.factor)))
            - 0.5 * n * math.log(2.0 * math.pi)
        )

    def local_step(params_local, opt_state_local, x_local, y_local):
        # leading dim 1: this restart group's single candidate
        p = jax.tree_util.tree_map(lambda l: l[0], params_local)
        o = jax.tree_util.tree_map(lambda l: l[0], opt_state_local)
        op = to_opt(p)
        lml, g = jax.value_and_grad(_local_lml)(op, x_local, y_local)
        g = jax.tree_util.tree_map(lambda v: -v, g)  # ascend
        updates, o_new = tx.update(g, o, op)
        op_new = optax.apply_updates(op, updates)
        expand = lambda t: jax.tree_util.tree_map(lambda l: l[None], t)
        return expand(from_opt(op_new)), expand(o_new), lml[None]

    step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(restart_axis), P(restart_axis), P(data_axis), P(data_axis)),
            out_specs=(P(restart_axis), P(restart_axis), P(restart_axis)),
            check_vma=False,
        )
    )

    def init_fn(params_batch):
        return jax.vmap(lambda p: tx.init(to_opt(p)))(params_batch)

    def step_fn(params_batch, opt_state, x, y) -> TrainStepResult:
        new_p, new_o, lml = step(params_batch, opt_state, x, y)
        return TrainStepResult(params=new_p, opt_state=new_o, lml=lml)

    return step_fn, init_fn
