"""
Filtering-mode assimilation template.

JAX rebuild of /root/reference/pytassim/interface/filter.py:29-165:
subclasses only implement ``estimate_weights``; this class handles
filtering-mode time slicing, the obs-operator application, optional weight
checkpointing, and weight application.
"""

from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp

from tpu_assim.interface.base import BaseAssimilation
from tpu_assim.observation import Observation
from tpu_assim.state import EnsembleState

__all__ = ["FilterAssimilation"]


class FilterAssimilation(BaseAssimilation):
    """Abstract class for filtering-based DA (ensemble Kalman filters)."""

    def _slice_analysis(
        self,
        analysis_time: float,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: EnsembleState,
    ) -> Tuple[EnsembleState, Sequence[Observation], EnsembleState]:
        """Filtering mode: slice state, obs, and pseudo state to the analysis
        time (reference: filter.py:38-54)."""
        idx = state.time_index(analysis_time)
        state = state.sel_time_index(idx)
        p_idx = pseudo_state.time_index(analysis_time)
        pseudo_state = pseudo_state.sel_time_index(p_idx)
        observations = [obs.sel_time(analysis_time) for obs in observations]
        return state, observations, pseudo_state

    def estimate_weights(
        self,
        state: EnsembleState,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        """Estimate the ensemble weights (abstract; reference:
        filter.py:56-94). Returns global ``[k, m]`` or per-gridpoint
        ``[grid, k, m]`` weights."""
        raise NotImplementedError

    def update_state(
        self,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        analysis_time: float,
    ) -> EnsembleState:
        """(reference: filter.py:96-165)"""
        prior_weights = self.generate_prior_weights(
            state.ens_size, dtype=state.dtype
        )
        pseudo_state = self.get_pseudo_state(
            pseudo_state=pseudo_state, state=state, weights=prior_weights
        )
        self._validate_state(pseudo_state)

        if not self.smoother:
            state, observations, pseudo_state = self._slice_analysis(
                analysis_time, state, observations, pseudo_state
            )
        ens_obs, filtered_obs = self._apply_obs_operator(
            pseudo_state, observations
        )
        return self._estimate_and_apply(state, filtered_obs, ens_obs)

    def _estimate_and_apply(
        self,
        state: EnsembleState,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> EnsembleState:
        """Estimate weights, optionally checkpoint them, apply them
        (reference: filter.py:155-165). Overridden by algorithms with a
        fused solve+apply fast path that never materializes the
        ``[grid, k, k]`` weights (LETKF method='cheb'/'fused1d')."""
        weights = self.estimate_weights(state, filtered_obs, ens_obs)
        if self.weight_save_path is not None:
            self.store_weights(weights)
            weights = self.load_weights()
        return self._apply_weights(state, weights)
