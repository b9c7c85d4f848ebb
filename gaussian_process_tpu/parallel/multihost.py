"""Multi-host (DCN) bring-up and host-coordination helpers (SURVEY.md C15).

The reference has no communication backend of any kind — no NCCL/MPI/Gloo/UCX,
no multiprocessing (SURVEY.md §2, parallelism statement). The equivalent
here is ``jax.distributed.initialize``: every host connects to a
coordinator over the network, after which ``jax.devices()`` is the *global*
device list and the same pjit/shard_map programs from :mod:`parallel.mesh`
span every host — XLA routes collectives over NVLink within a host and the
network across hosts. No custom transport is needed or wanted.

Bring-up order (each process):

    multihost.initialize(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh(restart=R)          # global devices
    xg   = multihost.host_local_to_global(mesh, P("data"), x_local)
    ...same sharded programs as single-host...

Exercised without a cluster by the loopback test (N processes on one
machine, DCN over localhost — SURVEY.md §4, strategy item 4).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_process_tpu.parallel import mesh as _mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Connect this process to the JAX distributed runtime (idempotent).

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) so launchers can configure
    bring-up without code changes. Under a cluster manager JAX knows
    (e.g. SLURM) all three may be None and JAX detects them; elsewhere
    nothing tells JAX of a cluster, so pass them.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def shutdown() -> None:
    """Tear down the distributed runtime (loopback tests re-init per process)."""
    try:
        jax.distributed.shutdown()
    except Exception:
        pass


def is_coordinator() -> bool:
    return jax.process_index() == 0


def global_mesh(*, restart: int = 1, data: Optional[int] = None) -> Mesh:
    """(restart, data) mesh over ALL global devices (every host sees the
    same mesh; call after :func:`initialize`)."""
    return _mesh.make_mesh(restart=restart, data=data, devices=jax.devices())


def host_local_to_global(
    mesh: Mesh, spec: P, local: np.ndarray
) -> jax.Array:
    """Assemble a global sharded array from per-process local shards.

    Each process passes its own rows (for ``P("data")`` row sharding); the
    result is one logical array spanning all hosts — the data-partitioned
    kernel-block layout of SURVEY.md C13 at multi-host scale.
    """
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.asarray(local)
    )


def replicate_to_global(mesh: Mesh, value) -> jax.Array:
    """Fully replicate a host-local value across every device of the mesh."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(value)
    )


def global_to_host_local(garray: jax.Array) -> np.ndarray:
    """Gather THIS process's addressable shards back to host memory, in
    row order (inverse of :func:`host_local_to_global` for row sharding)."""
    shards = sorted(
        (s for s in garray.addressable_shards), key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def fetch_replicated(garray: jax.Array) -> np.ndarray:
    """Host copy of a fully-replicated global array (any addressable shard)."""
    return np.asarray(garray.addressable_shards[0].data)


def sync_hosts(name: str = "sync", *, timeout_s: Optional[float] = None) -> None:
    """Barrier across all processes — failure detection in practice: a dead
    host makes this raise on every survivor (coordination-service
    DEADLINE_EXCEEDED), which is the signal to fail over (SURVEY.md §5,
    failure-detection row; exercised by the kill-one-host loopback test).

    ``timeout_s`` bounds how long survivors wait before declaring the
    barrier failed (default: jax's own multi-minute barrier timeout).
    """
    if timeout_s is None:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
        return
    client = jax._src.distributed.global_state.client
    if client is None:  # single-process: nothing to synchronise
        return
    client.wait_at_barrier(name, int(timeout_s * 1000))


def live_hosts() -> list:
    """Process ids the coordination service currently believes are alive —
    the detector behind elastic re-dispatch: after a host dies, survivors
    rebuild work assignments over this set (parallel/recovery.py)."""
    client = jax._src.distributed.global_state.client
    if client is None:
        return [0]
    live = client.get_live_nodes(list(range(jax.process_count())))
    return sorted(live)
