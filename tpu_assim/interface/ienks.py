"""
Iterative Ensemble Kalman Smoother interfaces (transform & bundle).

JAX rebuild of /root/reference/pytassim/interface/ienks.py:31-164.
The inner loop is one jitted batched call of the functional IEnKS core; the
learning rate ``tau`` is bounded to [0, 1] and ``epsilon`` to > 0, matching
the reference's ``bound_tensor`` setters (ienks.py:64-68, 137-155).
"""

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp

from tpu_assim.interface.variational import VarAssimilation
from tpu_assim.observation import Observation
from tpu_assim.ops.ienks import ienks_transform_step, ienks_bundle_step
from tpu_assim.state import EnsembleState
from tpu_assim.utils.decorators import bound_scalar

__all__ = ["IEnKSTransform", "IEnKSBundle"]


@jax.jit
def _ienks_transform_inner(weights, ens_obs_perts, innovations, tau):
    return ienks_transform_step(weights, ens_obs_perts, innovations[None, :], tau)


@jax.jit
def _ienks_bundle_inner(weights, ens_obs_perts, innovations, tau, epsilon):
    return ienks_bundle_step(
        weights, ens_obs_perts, innovations[None, :], tau, epsilon
    )


class IEnKSTransform(VarAssimilation):
    """IEnKS, transform version (reference: interface/ienks.py:31)."""

    def __init__(
        self,
        forward_model: Callable,
        tau: float = 1.0,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
    ):
        super().__init__(
            forward_model=forward_model,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self.tau = tau

    def __str__(self):
        return "IEnKSTransform(tau={0})".format(self.tau)

    def __repr__(self):
        return "IEnKSTransform({0})".format(repr(self.tau))

    @property
    def tau(self) -> float:
        return self._tau

    @tau.setter
    def tau(self, new_tau):
        """Bounded to [0, 1] (reference: ienks.py:64-68 via bound_tensor)."""
        self._tau = bound_scalar(new_tau, min_val=0.0, max_val=1.0, name="tau")

    def inner_loop(
        self,
        state: EnsembleState,
        weights: jnp.ndarray,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        """(reference: ienks.py:70-94)"""
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        return _ienks_transform_inner(
            weights, ens_obs_perts, innovations,
            jnp.asarray(self.tau, dtype=weights.dtype),
        )


class IEnKSBundle(IEnKSTransform):
    """IEnKS, bundle version with finite-difference scale ``epsilon``
    (reference: interface/ienks.py:97-164)."""

    def __init__(
        self,
        forward_model: Callable,
        tau: float = 1.0,
        epsilon: float = 1e-4,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
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
        self.epsilon = epsilon

    def __str__(self):
        return "IEnKSBundle(epsilon={0}, tau={1})".format(self.epsilon, self.tau)

    def __repr__(self):
        return "IEnKSBundle({0},{1})".format(repr(self.epsilon), repr(self.tau))

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @epsilon.setter
    def epsilon(self, new_epsilon):
        """Bounded to > 0 (reference: ienks.py:137-143 via bound_tensor)."""
        self._epsilon = bound_scalar(
            new_epsilon, min_val=0.0, max_val=None, name="epsilon"
        )

    def _get_model_weights(self, weights: jnp.ndarray) -> jnp.ndarray:
        """Bundle propagates with ``eps * I + mean(W)``
        (reference: ienks.py:157-164)."""
        ens_size = weights.shape[-2]
        weights_mean = jnp.mean(weights, axis=-1, keepdims=True)
        eps_eye = self.epsilon * jnp.eye(ens_size, dtype=weights.dtype)
        return eps_eye + weights_mean

    def inner_loop(
        self,
        state: EnsembleState,
        weights: jnp.ndarray,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        return _ienks_bundle_inner(
            weights, ens_obs_perts, innovations,
            jnp.asarray(self.tau, dtype=weights.dtype),
            jnp.asarray(self.epsilon, dtype=weights.dtype),
        )
