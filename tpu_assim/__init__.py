"""
tpu_assim — an ensemble data-assimilation engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
tobifinn/torch-assimilate (pytassim): ensemble transform Kalman filters
(ETKF/LETKF), kernelized variants (KETKF/LKETKF), iterative ensemble Kalman
smoothers (IEnKS transform/bundle, localized variants), Gaspari-Cohn
localization, observation operators, inflation/normalization transforms, and
Lorenz-96/84 toy models with RK4 integration — redesigned for accelerators:

* one jitted SPMD program end-to-end (no numpy<->torch bridging, no dask graph);
* the per-gridpoint LETKF solves are batched einsums + batched eigendecompositions
  on the device instead of a Python loop (reference: pytassim/interface/letkf.py:127-143
  runs `np.vectorize` per grid point);
* grid-domain parallelism via `jax.sharding` meshes + `shard_map` instead of dask
  chunking (reference: pytassim/interface/mixin_local.py:32-34);
* localization is exact fixed-size masking/top-k gathering instead of ragged
  per-column obs subsets (reference: pytassim/interface/wrapper.py:86-99).
"""

__version__ = "0.1.0"

from tpu_assim.state import EnsembleState
from tpu_assim.observation import Observation
from tpu_assim import ops

try:  # interface layer lands after the core; keep core importable standalone
    from tpu_assim.interface import (
        ETKF,
        LETKF,
        KETKF,
        LKETKF,
        IEnKSTransform,
        IEnKSBundle,
        LocalizedIEnKSTransform,
        LocalizedIEnKSBundle,
    )
except ImportError:  # pragma: no cover
    pass

__all__ = [
    "EnsembleState",
    "Observation",
    "ops",
    "interface",
    "ETKF",
    "LETKF",
    "KETKF",
    "LKETKF",
    "IEnKSTransform",
    "IEnKSBundle",
    "LocalizedIEnKSTransform",
    "LocalizedIEnKSBundle",
]
