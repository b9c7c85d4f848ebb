"""Device-mesh construction for multi-chip GP inference.

No reference equivalent — the reference is single-process NumPy with no
communication backend of any kind (SURVEY.md C13-C16). Scale-out here uses
a ``jax.sharding.Mesh`` over the cards (NVLink within a host); XLA inserts
the collectives (psum / all_gather / ppermute) and hands them to NCCL.

Axes:
- ``data``: shards kernel-matrix block-rows / training points (C13);
- ``restart``: shards independent hyperparameter-search restarts (C16).

Multi-host bring-up is ``jax.distributed.initialize`` (DCN) before mesh
construction; everything below is topology-agnostic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    *,
    data: Optional[int] = None,
    restart: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    cfg=None,
) -> Mesh:
    """Build a (restart, data) mesh. ``data=None`` uses all remaining devices.

    ``cfg`` (config.MeshConfig) supplies axis sizes; explicit arguments win.
    """
    if cfg is not None:
        if data is None:
            data = cfg.data_axis_size
        if restart is None:
            restart = cfg.restart_axis_size
    if restart is None:
        restart = 1
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        if n % restart:
            raise ValueError(f"{n} devices not divisible by restart={restart}")
        data = n // restart
    if restart * data > n:
        raise ValueError(f"mesh {restart}x{data} needs more than {n} devices")
    grid = np.asarray(devices[: restart * data]).reshape(restart, data)
    return Mesh(grid, axis_names=("restart", "data"))


def shard_rows(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for row-partitioned arrays (X, y, K block-rows)."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad axis 0 so it divides the mesh axis; returns (padded, original_len).

    Sharded layouts need equal per-device blocks; GP solves mask the padding
    (zero rows of K / zero entries of y contribute nothing to dot products)."""
    import jax.numpy as jnp

    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths), n
