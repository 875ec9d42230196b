"""
Multi-host SPMD runner.

The reference's multi-node story is a dask scheduler shipping serialized
chunks between workers (SURVEY §2.10; docs recommend
``dask.distributed`` — /root/reference/docs/source/user/algorithms/etkf.rst:53-56)
plus stale mpi4py pool examples (examples/benchmark_letkf_dist.py:105-112).
Here multi-host is the same single program: every host calls
``initialize_multihost()`` once, builds the same global mesh over all
devices of the pod slice, and runs the identical jitted analysis — XLA
routes the grid-axis collectives over the intra-host links and the network across
slices. There is no scheduler process at all.

Typical driver (same script on every host, e.g. launched by GKE/xmanager):

    from tpu_assim.parallel.multihost import (
        initialize_multihost, global_grid_mesh, host_local_to_global)

    initialize_multihost()                     # jax.distributed handshake
    mesh = global_grid_mesh()                  # all devices, ('grid',)
    state = host_local_to_global(mesh, local_state_shard)   # [k, g_global]
    analyse = halo_letkf_analysis(mesh, loc, ...)           # parallel/halo.py
    analysis = analyse(state, *sharded_obs)
"""

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_multihost",
    "global_grid_mesh",
    "host_local_to_global",
    "process_info",
]

GRID_AXIS = "grid"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """One-time ``jax.distributed`` handshake. With no arguments the cluster
    environment (cluster environment variables) is auto-detected; arguments are
    for manual bring-up. No-op when already initialized or single-process."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized (or single-process local run)
        pass


def process_info() -> dict:
    """Host/process topology snapshot for logging."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def global_grid_mesh(axis_name: str = GRID_AXIS) -> Mesh:
    """1-D mesh over ALL devices of the pod slice (every host must build the
    identical mesh; `jax.devices()` is globally consistent)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def host_local_to_global(
    mesh: Mesh,
    local_block: np.ndarray,
    axis: int = -1,
    axis_name: str = GRID_AXIS,
):
    """Assemble a global grid-sharded array from per-host local blocks
    without gathering: each host contributes the block of the grid dim its
    devices own (`jax.make_array_from_process_local_data`). ``local_block``
    is this host's contiguous slice along ``axis``."""
    ndim = np.ndim(local_block)
    axis = axis % ndim
    spec = tuple(axis_name if d == axis else None for d in range(ndim))
    sharding = NamedSharding(mesh, P(*spec))
    return jax.make_array_from_process_local_data(sharding, local_block)
