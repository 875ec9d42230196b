"""
Global ETKF algorithm.

JAX rebuild of /root/reference/pytassim/interface/etkf.py:36-120
(Bishop 2001 / Hunt 2007): global weight estimation in ensemble space,
followed by weight application. The reference's
``xr.apply_ufunc(..., dask='parallelized')`` call (etkf.py:108-119) is
replaced by one jitted call of the batched functional core.
"""

from typing import List, Optional

import jax
import jax.numpy as jnp

from tpu_assim.interface.filter import FilterAssimilation
from tpu_assim.observation import Observation
from tpu_assim.ops.etkf import etkf_weights
from tpu_assim.state import EnsembleState

__all__ = ["ETKF"]


@jax.jit
def _etkf_estimate(ens_obs_perts, innovations, inf_factor):
    return etkf_weights(ens_obs_perts, innovations[None, :], inf_factor)


class ETKF(FilterAssimilation):
    """Ensemble transform Kalman filter with global weights
    (reference: interface/etkf.py:36).

    Parameters
    ----------
    inf_factor : multiplicative covariance inflation rho (enters the weight
        solve as regularizer ``(K-1)/rho``, reference core/etkf.py:67).
    smoother : filtering (False) vs smoothing (True) mode.
    pre_transform / post_transform / weight_save_path / forward_model :
        see :class:`~tpu_assim.interface.base.BaseAssimilation`.
    """

    def __init__(
        self,
        inf_factor: float = 1.0,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
        forward_model=None,
    ):
        super().__init__(
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
            forward_model=forward_model,
        )
        self.inf_factor = inf_factor

    def __str__(self):
        return "Global ETKF(inf_factor={0})".format(self.inf_factor)

    def __repr__(self):
        return "ETKF({0})".format(repr(self.inf_factor))

    def estimate_weights(
        self,
        state: EnsembleState,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        """(reference: interface/etkf.py:99-120)"""
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        return _etkf_estimate(
            ens_obs_perts, innovations,
            jnp.asarray(self.inf_factor, dtype=ens_obs_perts.dtype),
        )
