"""
Localized IEnKS (transform & bundle).

JAX rebuild of /root/reference/pytassim/interface/lienks.py:31-163:
the IEnKS inner step per grid column, with localized (sqrt-weight-scaled)
obs-space inputs. The reference skips localizing the weight argument
(``args_to_skip=(0,)``, lienks.py:106-113); here that is structural — the
per-column weights are batched while perts/innovations are scaled per column.
"""

from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp

from tpu_assim.interface.ienks import IEnKSTransform, IEnKSBundle
from tpu_assim.interface.mixin_local import DomainLocalizedMixin
from tpu_assim.observation import Observation
from tpu_assim.ops.ienks import ienks_transform_step, ienks_bundle_step
from tpu_assim.state import EnsembleState

__all__ = ["LocalizedIEnKSTransform", "LocalizedIEnKSBundle"]


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _lienks_solve(
    localization, chunksize, step_kind, max_obs, selection, strict,
    weights, ens_obs_perts, innovations, grid_info, obs_info, tau, epsilon,
):
    from tpu_assim.ops.localization import (
        neighborhood_select,
        neighborhood_select_window,
        safe_sqrt,
    )

    n_grid = grid_info.shape[0]
    ens_size = ens_obs_perts.shape[-2]
    if weights.ndim == 2:
        weights = jnp.broadcast_to(weights, (n_grid, ens_size, ens_size))

    def chunk_fn(chunk):
        grid_chunk, w_chunk = chunk
        if localization is not None and max_obs is not None:
            # Fast localized path: fixed-size obs
            # neighborhoods, O(g * k * nb) instead of the dense
            # O(g * k * o) scaled tensors — exact whenever no column has
            # more nonzero-taper obs than max_obs (zero-scaled components
            # contribute nothing to the inner-step Grams).
            if selection == "window":
                idx, w_nbh = neighborhood_select_window(
                    localization, grid_chunk, obs_info, max_obs,
                    strict=strict,
                )
            else:
                idx, w_nbh = neighborhood_select(
                    localization, grid_chunk, obs_info, max_obs
                )
            sqrt_w = safe_sqrt(w_nbh).astype(ens_obs_perts.dtype)  # [c, nb]
            scaled_perts = (
                ens_obs_perts[:, idx].transpose(1, 0, 2)
                * sqrt_w[:, None, :]
            )                                                # [c, k, nb]
            scaled_obs = (innovations[idx] * sqrt_w)[:, None, :]
        else:
            if localization is None:
                w_loc = jnp.ones(
                    (grid_chunk.shape[0], obs_info.shape[0]),
                    dtype=ens_obs_perts.dtype,
                )
            else:
                w_loc = localization.taper_weights(
                    grid_chunk, obs_info
                ).astype(ens_obs_perts.dtype)
            # safe_sqrt: zero taper weights otherwise NaN reverse-mode AD
            sqrt_w = safe_sqrt(w_loc)
            scaled_perts = ens_obs_perts[None, :, :] * sqrt_w[:, None, :]
            scaled_obs = (innovations[None, :] * sqrt_w)[:, None, :]
        if step_kind == "bundle":
            return ienks_bundle_step(
                w_chunk, scaled_perts, scaled_obs, tau, epsilon
            )
        return ienks_transform_step(w_chunk, scaled_perts, scaled_obs, tau)

    if chunksize is None or chunksize >= n_grid:
        return chunk_fn((grid_info, weights))
    n_chunks = -(-n_grid // chunksize)
    pad = n_chunks * chunksize - n_grid
    g_pad = jnp.concatenate(
        [grid_info, jnp.broadcast_to(grid_info[-1:], (pad,) + grid_info.shape[1:])],
        axis=0,
    ).reshape((n_chunks, chunksize) + grid_info.shape[1:])
    w_pad = jnp.concatenate(
        [weights, jnp.broadcast_to(weights[-1:], (pad,) + weights.shape[1:])],
        axis=0,
    ).reshape((n_chunks, chunksize) + weights.shape[1:])
    out = jax.lax.map(chunk_fn, (g_pad, w_pad))
    return out.reshape((n_chunks * chunksize,) + out.shape[2:])[:n_grid]


class LocalizedIEnKSTransform(DomainLocalizedMixin, IEnKSTransform):
    """Localized IEnKS transform (reference: lienks.py:31-118)."""

    _step_kind = "transform"

    def __init__(
        self,
        forward_model: Callable,
        localization=None,
        tau: float = 1.0,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
    ):
        super().__init__(
            forward_model=forward_model,
            tau=tau,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.max_obs_strict = max_obs_strict

    def __str__(self):
        return "Localized IEnKSTransform(loc={0}, tau={1})".format(
            str(self.localization), self.tau
        )

    def __repr__(self):
        return "LIEnKSTransform({0},{1})".format(
            repr(self.localization), repr(self.tau)
        )

    def inner_loop(
        self,
        state: EnsembleState,
        weights: jnp.ndarray,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        """(reference: lienks.py:68-118)"""
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        grid_info = state.grid_info()
        epsilon = getattr(self, "epsilon", 0.0)
        return _lienks_solve(
            self.localization,
            self.chunksize,
            self._step_kind,
            self.max_obs,
            self.selection,
            self.max_obs_strict,
            weights,
            ens_obs_perts,
            innovations,
            grid_info,
            obs_info,
            jnp.asarray(self.tau, dtype=ens_obs_perts.dtype),
            jnp.asarray(epsilon, dtype=ens_obs_perts.dtype),
        )


class LocalizedIEnKSBundle(LocalizedIEnKSTransform, IEnKSBundle):
    """Localized IEnKS bundle (reference: lienks.py:121-163)."""

    _step_kind = "bundle"

    def __init__(
        self,
        forward_model: Callable,
        localization=None,
        tau: float = 1.0,
        epsilon: float = 1e-4,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
    ):
        IEnKSBundle.__init__(
            self,
            forward_model=forward_model,
            tau=tau,
            epsilon=epsilon,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.max_obs_strict = max_obs_strict

    def __str__(self):
        return "Localized IEnKSBundle(loc={0}, eps={1}, tau={2})".format(
            str(self.localization), self.epsilon, self.tau
        )

    def __repr__(self):
        return "LIEnKSBundle({0},{1},{2})".format(
            repr(self.localization), repr(self.epsilon), repr(self.tau)
        )

    inner_loop = LocalizedIEnKSTransform.inner_loop
