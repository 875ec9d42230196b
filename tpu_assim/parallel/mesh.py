"""
Device-mesh construction and state sharding.

JAX replacement for the reference's distribution layer: pytassim
distributes the per-gridpoint LETKF solves with dask chunking of the ``grid``
dim (/root/reference/pytassim/interface/letkf.py:121-123,
mixin_local.py:32-34) and leaves multi-node execution to the dask scheduler.
Here the same embarrassing parallelism is expressed as an SPMD program over a
``jax.sharding.Mesh``: the grid dim is sharded across devices, observations
are replicated (exactly the reference's semantics — it ships the full obs
arrays to every chunk, letkf.py:122-123), and the ensemble dim stays
replicated/minor since each K x K solve lives on one chip.

A second mesh axis ``ens`` is available for the forecast phase: ensemble
members integrate independently, so model propagation shards over members
while the analysis shards over grid columns — XLA inserts the resharding
collective between phases.

Multi-host: the same program runs under ``jax.distributed.initialize``; the
mesh then spans all hosts' devices and the grid axis rides the interconnect (NVLink within a host).
"""

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_assim.state import EnsembleState

__all__ = [
    "make_grid_mesh",
    "make_forecast_analysis_mesh",
    "shard_state",
    "replicate",
    "GRID_AXIS",
    "ENS_AXIS",
]

GRID_AXIS = "grid"
ENS_AXIS = "ens"


def make_grid_mesh(
    n_devices: Optional[int] = None, devices=None
) -> Mesh:
    """1-D mesh over the grid axis (the load-bearing DA parallelism)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (GRID_AXIS,))


def make_forecast_analysis_mesh(
    ens_shards: int, grid_shards: int, devices=None
) -> Mesh:
    """2-D mesh ``(ens, grid)``: the forecast phase shards ensemble members
    over ``ens`` (members integrate independently), the analysis phase shards
    grid columns over both axes flattened."""
    if devices is None:
        devices = jax.devices()
    n = ens_shards * grid_shards
    if len(devices) < n:
        raise ValueError(
            "mesh needs {0} devices, have {1}".format(n, len(devices))
        )
    dev_array = np.asarray(devices[:n]).reshape(ens_shards, grid_shards)
    return Mesh(dev_array, (ENS_AXIS, GRID_AXIS))


def shard_state(state: EnsembleState, mesh: Mesh) -> EnsembleState:
    """Place a state with its grid dim sharded over the mesh's grid axis and
    coordinates replicated (times) / grid-sharded (grid_coords)."""
    data_sharding = NamedSharding(mesh, P(None, None, None, GRID_AXIS))
    coord_sharding = NamedSharding(mesh, P(GRID_AXIS, None))
    rep = NamedSharding(mesh, P())
    return state.replace(
        data=jax.device_put(state.data, data_sharding),
        grid_coords=jax.device_put(state.grid_coords, coord_sharding),
        times=jax.device_put(state.times, rep),
    )


def replicate(value, mesh: Mesh):
    """Replicate an array over the whole mesh."""
    return jax.device_put(value, NamedSharding(mesh, P()))
