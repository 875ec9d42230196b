"""
Domain-localization mixin.

JAX rebuild of /root/reference/pytassim/interface/mixin_local.py:31-69.
The reference extracts pandas MultiIndex frames for the per-gridpoint
localization loop; here the state/obs coordinate arrays are already explicit
(:meth:`EnsembleState.grid_info`, :meth:`Observation.stacked_coords`) and the
localized solve is a batched, optionally grid-chunked jnp computation.

``chunksize`` keeps the reference parameter name (mixin_local.py:32-34) but
means something better on an accelerator: the number of grid columns whose
``[chunk, n_obs]`` taper-weight block is materialized at once (bounding HBM
footprint), processed sequentially with ``lax.map`` — not a dask chunk.
"""

from typing import Callable, Optional

import jax
import jax.numpy as jnp

__all__ = ["DomainLocalizedMixin", "map_grid_chunked"]


def map_grid_chunked(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    grid_info: jnp.ndarray,
    chunk_size: Optional[int],
):
    """Apply ``fn`` over ``grid_info [g, d]`` in chunks of ``chunk_size``
    columns; the padded tail is computed and discarded. ``fn`` must map
    ``[c, d] -> [c, ...]``."""
    n_grid = grid_info.shape[0]
    if chunk_size is None or chunk_size >= n_grid:
        return fn(grid_info)
    n_chunks = -(-n_grid // chunk_size)
    pad = n_chunks * chunk_size - n_grid
    padded = jnp.concatenate(
        [grid_info, jnp.broadcast_to(grid_info[-1:], (pad,) + grid_info.shape[1:])],
        axis=0,
    )
    chunks = padded.reshape((n_chunks, chunk_size) + grid_info.shape[1:])
    out = jax.lax.map(fn, chunks)
    out = out.reshape((n_chunks * chunk_size,) + out.shape[2:])
    return out[:n_grid]


class DomainLocalizedMixin:
    """Shared helpers for domain-localized algorithms (LETKF, LKETKF,
    localized IEnKS)."""

    def _localized_obs_weights(
        self,
        grid_info: jnp.ndarray,
        obs_info: jnp.ndarray,
        dtype,
    ) -> jnp.ndarray:
        """Taper weights [g, l] for every grid column; all-ones when no
        localization is set (the reference treats localization=None as an
        unlocalized per-gridpoint ETKF, interface/letkf.py:51-55 with
        wrapper.py:88-98)."""
        n_grid = grid_info.shape[0]
        n_obs = obs_info.shape[0]
        if self.localization is None:
            return jnp.ones((n_grid, n_obs), dtype=dtype)
        return self.localization.taper_weights(grid_info, obs_info).astype(dtype)
