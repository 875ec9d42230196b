"""SPMD parallelism over device meshes (replaces the reference's dask
distribution, SURVEY §2.10)."""

from tpu_assim.parallel.mesh import (
    make_grid_mesh,
    make_forecast_analysis_mesh,
    shard_state,
    replicate,
    GRID_AXIS,
    ENS_AXIS,
)
from tpu_assim.parallel.letkf import (
    sharded_letkf_weights,
    sharded_letkf_analysis,
)

__all__ = [
    "make_grid_mesh",
    "make_forecast_analysis_mesh",
    "shard_state",
    "replicate",
    "GRID_AXIS",
    "ENS_AXIS",
    "sharded_letkf_weights",
    "sharded_letkf_analysis",
]
