"""
Variational (outer-loop) assimilation template.

JAX rebuild of /root/reference/pytassim/interface/variational.py:33-136:
an outer Gauss–Newton loop that alternates model propagation, obs-operator
application, and a weight-space ``inner_loop``.

The reference must materialize the weights to netCDF every iteration to
truncate the growing dask graph (``precompute_weights``,
variational.py:55-77). Here the analog is a ``block_until_ready`` — each
iteration's weights are a concrete device array, so there is no graph to
truncate; the optional checkpoint roundtrip is kept for the
``weight_save_path`` workflow.
"""

from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp

from tpu_assim.interface.base import BaseAssimilation
from tpu_assim.observation import Observation
from tpu_assim.state import EnsembleState

__all__ = ["VarAssimilation"]


class VarAssimilation(BaseAssimilation):
    """Abstract outer-loop variational assimilation
    (reference: variational.py:33).

    Parameters
    ----------
    forward_model : callable ``(state, iter_num) -> (state, pseudo_state)``
        propagating the weighted ensemble; required.
    max_iter : number of outer iterations.
    """

    def __init__(
        self,
        forward_model: Callable,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
    ):
        super().__init__(
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            forward_model=forward_model,
            weight_save_path=weight_save_path,
        )
        self.max_iter = max_iter

    def precompute_weights(self, weights: jnp.ndarray) -> jnp.ndarray:
        """Materialize the weights (reference: variational.py:55-77 stores and
        reloads netCDF to break the dask graph; here the device computation is
        forced, and the checkpoint roundtrip only happens when a save path is
        set)."""
        weights = jax.block_until_ready(weights)
        if self.weight_save_path is not None:
            self.store_weights(weights)
            weights = self.load_weights()
        return weights

    def inner_loop(
        self,
        state: EnsembleState,
        weights: jnp.ndarray,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        """(abstract; reference: variational.py:79-87)"""
        raise NotImplementedError

    def _outer_step(
        self,
        weights: jnp.ndarray,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        iter_num: int = 0,
    ) -> jnp.ndarray:
        """(reference: variational.py:89-107)"""
        pseudo_state = self.get_pseudo_state(
            pseudo_state=pseudo_state,
            state=state,
            weights=weights,
            iter_num=iter_num,
        )
        ens_obs, filtered_obs = self._apply_obs_operator(
            pseudo_state, observations
        )
        weights = self.inner_loop(state, weights, filtered_obs, ens_obs)
        return weights

    def update_state(
        self,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        analysis_time: float,
    ) -> EnsembleState:
        """(reference: variational.py:109-135)"""
        weights = self.generate_prior_weights(state.ens_size, dtype=state.dtype)
        state = state.sel_time_index(state.time_index(analysis_time))
        for iter_num in range(self.max_iter):
            weights = self._outer_step(
                weights=weights,
                state=state,
                observations=observations,
                pseudo_state=pseudo_state,
                iter_num=iter_num,
            )
            weights = self.precompute_weights(weights)
            pseudo_state = None
        analysis_state = self._apply_weights(state, weights)
        if self.smoother:
            analysis_state, _ = self.forward_model(analysis_state, self.max_iter)
        return analysis_state
