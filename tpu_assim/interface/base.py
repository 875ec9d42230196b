"""
Base assimilation interface: the ``assimilate()`` template method.

JAX rebuild of /root/reference/pytassim/interface/base.py:52-512.
The orchestration contract is identical — validate -> select analysis time ->
pre-transforms -> ``update_state`` -> post-transforms -> validate — but the
execution model is redesigned: there is no numpy<->torch bridge
(reference wrapper.py:29-63) and no dask graph; the entire weight estimation
and application path is one jitted JAX program over the
:class:`~tpu_assim.state.EnsembleState` / :class:`~tpu_assim.observation.Observation`
pytrees. Host code only does validation, time selection, and I/O.
"""

import logging
import time as _time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tpu_assim.state import EnsembleState, StateError
from tpu_assim.observation import Observation, ObservationError

_HIGHEST = jax.lax.Precision.HIGHEST

logger = logging.getLogger(__name__)

__all__ = ["BaseAssimilation"]


class BaseAssimilation:
    """Abstract base for all assimilation algorithms
    (reference: pytassim/interface/base.py:52).

    Parameters
    ----------
    smoother : apply weights to the whole time window (True) or only the
        analysis time (False) — reference: interface/base.py:61.
    pre_transform / post_transform : iterables of
        :class:`~tpu_assim.transform.BaseTransformer` applied around
        ``update_state`` (reference: base.py:493-506).
    forward_model : optional callable ``(state, iter_num) -> (state, pseudo_state)``
        used to propagate the model ensemble (reference: base.py:330-357).
    weight_save_path : optional path; estimated weights are checkpointed there
        and reloaded before application (reference: base.py:280-325).

    Note: the reference's ``gpu`` flag (base.py:107-122) has no analog — the
    whole program runs on the default JAX device by construction.
    """

    def __init__(
        self,
        smoother: bool = False,
        pre_transform: Optional[Iterable] = None,
        post_transform: Optional[Iterable] = None,
        forward_model: Optional[Callable] = None,
        weight_save_path: Optional[str] = None,
    ):
        self.smoother = smoother
        self.pre_transform = pre_transform
        self.post_transform = post_transform
        self.forward_model = forward_model
        self.weight_save_path = weight_save_path

    # ------------------------------------------------------------- validation
    @staticmethod
    def _validate_state(state: EnsembleState):
        """(reference: base.py:128-138)"""
        if not isinstance(state, EnsembleState):
            raise TypeError("state must be an EnsembleState")
        if not state.valid:
            raise StateError("Given state is not a valid state!")

    @staticmethod
    def _validate_single_obs(observation: Observation):
        if not isinstance(observation, Observation):
            raise TypeError("observations must be Observation instances")
        if not observation.valid:
            raise ObservationError("Given observation is not valid!")

    def _validate_observations(self, observations: Sequence[Observation]):
        """(reference: base.py:140-151)"""
        for obs in observations:
            self._validate_single_obs(obs)

    # ---------------------------------------------------------- analysis time
    @staticmethod
    def _get_analysis_time(
        state: EnsembleState, analysis_time: Optional[float] = None
    ) -> float:
        """None selects the last state time, otherwise the nearest state time
        (reference: base.py:153-178)."""
        times = np.asarray(state.times)
        if analysis_time is None:
            return float(times[-1])
        idx = int(np.argmin(np.abs(times - float(analysis_time))))
        return float(times[idx])

    # ------------------------------------------------------------ obs operator
    @staticmethod
    def _apply_obs_operator(
        pseudo_state: EnsembleState, observations: Sequence[Observation]
    ) -> Tuple[List[jnp.ndarray], List[Observation]]:
        """Apply each observation's operator to the pseudo state; drop
        observations without an operator (reference: base.py:180-220 catches
        ``NotImplementedError``).

        Returns a list of ens-obs equivalents ``[time, ens, obs]`` and the
        filtered observation list.
        """
        ens_obs, filtered = [], []
        for obs in observations:
            if obs.operator is None:
                continue
            try:
                equivalent = obs.operator(obs, pseudo_state)
            except NotImplementedError:
                continue
            ens_obs.append(jnp.asarray(equivalent))
            filtered.append(obs)
        return ens_obs, filtered

    # -------------------------------------------------- obs-space preparation
    @staticmethod
    def _get_obs_space_variables(
        ens_obs: Sequence[jnp.ndarray], observations: Sequence[Observation]
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Innovations + normalized ens perturbations, stacked over all obs
        subsets into a flat ``obs_id`` dim (reference: base.py:359-379 with
        the stacking of base.py:222-241).

        Parameters
        ----------
        ens_obs : list of [time, ens, obs] ensemble obs equivalents.
        observations : matching list of Observations.

        Returns
        -------
        innovations : [obs_id] normalized innovations (R^{-1/2} (y - H x_mean)).
        ens_obs_perts : [ens, obs_id] normalized perturbations.
        obs_info : [obs_id, 1 + n_coord] stacked obs coordinates (time first).
        """
        innov_list, perts_list, info_list = [], [], []
        for equivalent, obs in zip(ens_obs, observations):
            mean = jnp.mean(equivalent, axis=1, keepdims=True)  # [time,1,obs]
            perts = equivalent - mean  # [time, ens, obs]
            innovation = obs.observations - mean[:, 0, :]  # [time, obs]
            innovation = obs.mul_rcinv(innovation)
            # normalize perts: mul_rcinv expects obs-last layout; move ens in
            # front of time so [ens, time, obs] broadcasts over time covs.
            perts_et = jnp.swapaxes(perts, 0, 1)  # [ens, time, obs]
            perts_et = obs.mul_rcinv(perts_et)
            n_time, n_obs = innovation.shape
            innov_list.append(innovation.reshape(n_time * n_obs))
            perts_list.append(perts_et.reshape(perts_et.shape[0], n_time * n_obs))
            info_list.append(obs.stacked_coords())
        innovations = jnp.concatenate(innov_list, axis=0)
        ens_obs_perts = jnp.concatenate(perts_list, axis=1)
        obs_info = jnp.concatenate(info_list, axis=0)
        return innovations, ens_obs_perts, obs_info

    # --------------------------------------------------------------- weights
    @staticmethod
    def generate_prior_weights(ens_size: int, dtype=None) -> jnp.ndarray:
        """Identity prior weights (reference: base.py:243-254)."""
        return jnp.eye(ens_size, dtype=dtype)

    @staticmethod
    def _apply_weights(state: EnsembleState, weights: jnp.ndarray) -> EnsembleState:
        """Analysis = mean + Z W, contracting the ensemble dim
        (reference: base.py:256-278 ``xr.dot(state_perts, weights,
        dims='ensemble')``). Weights are either global ``[k, m]`` or
        per-gridpoint ``[grid, k, m]``."""
        state_mean, state_perts = state.split_mean_perts()
        if weights.ndim == 2:
            analysis_perts = jnp.einsum("vtkg,km->vtmg", state_perts, weights,
                                        precision=_HIGHEST)
        elif weights.ndim == 3:
            analysis_perts = jnp.einsum("vtkg,gkm->vtmg", state_perts, weights,
                                        precision=_HIGHEST)
        else:
            raise ValueError(
                "weights must be [k, m] or [grid, k, m], got shape "
                "{0}".format(weights.shape)
            )
        analysis = state_mean + analysis_perts
        return state.replace(data=analysis)

    # ------------------------------------------------------- weight checkpoint
    def store_weights(self, weights: jnp.ndarray):
        """Checkpoint the estimated weights (reference: base.py:280-302 writes
        netCDF; here HDF5 via :mod:`tpu_assim.utils.checkpoint`)."""
        from tpu_assim.utils.checkpoint import save_weights

        save_weights(self.weight_save_path, weights)

    def load_weights(self) -> jnp.ndarray:
        """(reference: base.py:304-325)"""
        from tpu_assim.utils.checkpoint import load_weights

        return load_weights(self.weight_save_path)

    # --------------------------------------------------------- model coupling
    def _get_model_weights(self, weights: jnp.ndarray) -> jnp.ndarray:
        """(reference: base.py:327-328; overridden by IEnKSBundle)"""
        return weights

    def propagate_model(
        self,
        weights: jnp.ndarray,
        state: EnsembleState,
        iter_num: int = 0,
    ) -> EnsembleState:
        """Apply (model) weights and run the forward model
        (reference: base.py:330-341)."""
        model_weights = self._get_model_weights(weights)
        model_state = self._apply_weights(state, model_weights)
        _, pseudo_state = self.forward_model(model_state, iter_num)
        self._validate_state(pseudo_state)
        return pseudo_state

    def get_pseudo_state(
        self,
        pseudo_state: Optional[EnsembleState],
        state: EnsembleState,
        weights: jnp.ndarray,
        iter_num: int = 0,
    ) -> EnsembleState:
        """(reference: base.py:343-357)"""
        if pseudo_state is None and self.forward_model is not None:
            return self.propagate_model(weights, state, iter_num)
        if pseudo_state is None:
            return state
        return pseudo_state

    # -------------------------------------------------------------- template
    def update_state(
        self,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        analysis_time: float,
    ) -> EnsembleState:
        raise NotImplementedError

    def assimilate(
        self,
        state: EnsembleState,
        observations: Union[Observation, Sequence[Observation]],
        pseudo_state: Optional[EnsembleState] = None,
        analysis_time: Optional[float] = None,
    ) -> EnsembleState:
        """The assimilation template method (reference: base.py:419-512):
        validate, resolve the analysis time, run pre-transforms, dispatch to
        ``update_state``, run post-transforms, validate the analysis."""
        start = _time.time()
        if observations is None or (
            isinstance(observations, (list, tuple, set)) and not observations
        ):
            import warnings

            warnings.warn(
                "No observation is given, I will return the background state!",
                UserWarning,
            )
            return state
        if not isinstance(observations, (list, set, tuple)):
            observations = (observations,)
        observations = tuple(observations)
        self._validate_state(state)
        self._validate_observations(observations)
        analysis_time = self._get_analysis_time(state, analysis_time)
        if self.pre_transform:
            for trans in self.pre_transform:
                state, observations, pseudo_state = trans.pre(
                    state, observations, pseudo_state
                )
        analysis = self.update_state(
            state, observations, pseudo_state, analysis_time
        )
        if self.post_transform:
            for trans in self.post_transform:
                analysis = trans.post(
                    analysis, state, observations, pseudo_state
                )
        self._validate_state(analysis)
        logger.info(
            "Finished assimilation after %.2f s", _time.time() - start
        )
        return analysis
