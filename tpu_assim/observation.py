"""
Observation container with R^{-1/2} normalization.

JAX replacement for the reference's xarray accessor ``Observation``
(/root/reference/pytassim/observation.py:52-299): a registered pytree holding
the observation values ``[time, obs]``, the observation covariance (diagonal
vector, possibly time-dependent, or a full correlated matrix), explicit
observation coordinates for localization, and the attached observation
operator.

The R^{-1/2} normalization (reference: observation.py:241-295) is:

* uncorrelated: multiply by ``1/sqrt(var)`` (observation.py:241-245);
* correlated: right-multiply by the inverse upper Cholesky factor
  ``U^{-1}`` with ``U = chol(R)^T`` (observation.py:247-271) — implemented
  here as a batched triangular solve instead of an explicit inverse.
"""

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Observation", "ObservationError"]


class ObservationError(Exception):
    """Raised when an observation container fails validation
    (reference: pytassim/observation.py:44-49)."""


@jax.tree_util.register_pytree_node_class
class Observation:
    """Observations + covariance + coordinates + operator.

    Parameters
    ----------
    observations : [time, obs] array of observed values.
    covariance : observation covariance R. Accepted shapes (mirroring the
        reference's valid layouts, observation.py:155-203):
        ``[obs]`` (diagonal), ``[time, obs]`` (time-dependent diagonal),
        ``[obs, obs]`` (correlated), ``[time, obs, obs]`` (time-dependent
        correlated).
    obs_coords : [obs, n_coord] float coordinates for localization distances.
    times : [time] float times (same units as the state's times).
    operator : callable ``(obs, pseudo_state) -> [time, ens, obs]`` mapping a
        state into observation space (the reference attaches this to the
        dataset as ``ds.obs.operator``, observation.py:297-299).
    correlated : explicitly mark the covariance as correlated; inferred from
        the shape when unambiguous.
    """

    def __init__(
        self,
        observations,
        covariance,
        obs_coords=None,
        times=None,
        operator: Optional[Callable] = None,
        correlated: Optional[bool] = None,
    ):
        observations = jnp.atleast_2d(jnp.asarray(observations))
        covariance = jnp.asarray(covariance)
        n_time, n_obs = observations.shape
        if correlated is None:
            # Infer from the covariance shape (the reference infers from the
            # presence of the `obs_grid_2` dim, observation.py:100-111).
            # Ambiguous square [time, obs] == [obs, obs] cases default to
            # uncorrelated; pass `correlated=True` explicitly there.
            if covariance.ndim == 1:
                correlated = False
            elif covariance.ndim == 3:
                correlated = True
            else:
                correlated = covariance.shape == (n_obs, n_obs) and (
                    covariance.shape != (n_time, n_obs)
                )
        self.observations = observations
        self.covariance = covariance
        self.obs_coords = (
            jnp.arange(n_obs, dtype=observations.dtype)[:, None]
            if obs_coords is None
            else jnp.atleast_2d(jnp.asarray(obs_coords).T).T
            if jnp.asarray(obs_coords).ndim == 1
            else jnp.asarray(obs_coords)
        )
        self.times = (
            jnp.arange(n_time, dtype=observations.dtype)
            if times is None
            else jnp.atleast_1d(jnp.asarray(times))
        )
        self.operator = operator
        self.correlated = bool(correlated)

    # ------------------------------------------------------------------ pytree
    def tree_flatten(self):
        children = (self.observations, self.covariance, self.obs_coords, self.times)
        aux = (self.operator, self.correlated)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.observations, obj.covariance, obj.obs_coords, obj.times) = children
        obj.operator, obj.correlated = aux
        return obj

    def replace(self, **kwargs) -> "Observation":
        obj = object.__new__(Observation)
        for name in ("observations", "covariance", "obs_coords", "times",
                     "operator", "correlated"):
            setattr(obj, name, kwargs.get(name, getattr(self, name)))
        return obj

    # ------------------------------------------------------------- properties
    @property
    def n_obs(self) -> int:
        return self.observations.shape[-1]

    @property
    def n_times(self) -> int:
        return self.observations.shape[0]

    @property
    def time_dependent_cov(self) -> bool:
        if self.correlated:
            return self.covariance.ndim == 3
        return self.covariance.ndim == 2

    @property
    def valid(self) -> bool:
        """Shape validation mirroring the reference's accessor checks
        (observation.py:100-239)."""
        try:
            ok = self.observations.ndim == 2
            n_time, n_obs = self.observations.shape
            ok &= self.times.shape[0] == n_time
            ok &= self.obs_coords.shape[0] == n_obs
            if self.correlated:
                if self.covariance.ndim == 3:
                    ok &= self.covariance.shape == (n_time, n_obs, n_obs)
                else:
                    ok &= self.covariance.shape == (n_obs, n_obs)
            else:
                if self.covariance.ndim == 2:
                    ok &= self.covariance.shape == (n_time, n_obs)
                else:
                    ok &= self.covariance.shape == (n_obs,)
            return bool(ok)
        except Exception:
            return False

    # ------------------------------------------------------- R^{-1/2} scaling
    def mul_rcinv(self, value: jnp.ndarray) -> jnp.ndarray:
        """Normalize ``value`` by R^{-1/2} (reference entry point:
        observation.py:290-295).

        ``value`` has the obs dimension last: ``[..., time, obs]`` (or any
        leading dims for ensemble perturbations).
        """
        if self.correlated:
            return self._corr_normalize(value)
        return self._uncorr_normalize(value)

    def _uncorr_normalize(self, value: jnp.ndarray) -> jnp.ndarray:
        """Diagonal case: divide by the standard deviation
        (reference: observation.py:241-245, 273-275)."""
        return value / jnp.sqrt(self.covariance)

    def _corr_normalize(self, value: jnp.ndarray) -> jnp.ndarray:
        """Correlated case: ``value @ U^{-1}`` with ``U = chol(R)^T``
        (reference: observation.py:247-271). ``z = v U^{-1}`` is solved as the
        lower-triangular system ``L z^T = v^T`` with ``L = chol(R)``.
        """
        from jax.scipy.linalg import solve_triangular

        def solve_one(cov, val):
            # flatten all leading dims: solve_triangular wants matching
            # batch ranks, and ``val`` may be [ens, time, obs] perturbations
            chol_l = jnp.linalg.cholesky(cov)
            flat = val.reshape(-1, val.shape[-1])          # [b, obs]
            zt = solve_triangular(chol_l, flat.T, lower=True)
            return zt.T.reshape(val.shape)

        if self.covariance.ndim == 3:
            # time-dependent: solve per time step (reference loops per time,
            # observation.py:255-262); vmap over the time axis.
            def per_time(cov_t, val_t):
                return solve_one(cov_t, val_t)

            # value [..., time, obs] -> move time to front for vmap
            val_tm = jnp.moveaxis(value, -2, 0)
            out = jax.vmap(per_time, in_axes=(0, 0))(self.covariance, val_tm[..., None, :])
            out = out[..., 0, :]
            return jnp.moveaxis(out, 0, -2)
        return solve_one(self.covariance, value)

    def __repr__(self):
        return "Observation(times={0}, obs={1}, correlated={2})".format(
            self.n_times, self.n_obs, self.correlated
        )

    # ---------------------------------------------------------- time slicing
    def sel_time(self, time_value: float) -> "Observation":
        """Host-side time selection, the analog of
        ``obs.sel(time=[analysis_time])`` in the reference's filtering mode
        (interface/filter.py:48-52). Raises ``KeyError`` when the time is not
        present, as xarray ``sel`` would.

        Matching is by rounding-tolerant closeness (rtol 1e-12 plus a tiny
        absolute floor), not exact float equality: the analysis time is
        chosen by *nearest* state time (interface/base.py), and a state/obs
        time pair differing only in the last float bits must still pair up —
        the reference gets this for free from pandas timestamp equality,
        float coordinates do not.
        """
        times = np.asarray(self.times)
        idx = np.nonzero(
            np.isclose(times, float(time_value), rtol=1e-12, atol=1e-12)
        )[0]
        if idx.size == 0:
            raise KeyError(
                "time {0} not found in observation times".format(time_value)
            )
        idx = np.sort(idx)
        covariance = self.covariance
        if self.time_dependent_cov:
            covariance = jnp.take(covariance, jnp.asarray(idx), axis=0)
        return self.replace(
            observations=jnp.take(self.observations, jnp.asarray(idx), axis=0),
            covariance=covariance,
            times=jnp.take(self.times, jnp.asarray(idx), axis=0),
        )

    # ------------------------------------------------------------ obs stacking
    def stacked_coords(self) -> jnp.ndarray:
        """Coordinates of the flattened ``obs_id = (time, obs)`` dimension,
        with the obs time as column 0 — the layout localization distance
        functions receive (reference builds the same frame from the
        ``obs_id`` MultiIndex: interface/mixin_local.py:44-47).

        Returns [time * obs, 1 + n_coord].
        """
        n_time, n_obs = self.observations.shape
        t_col = jnp.repeat(
            self.times.astype(self.obs_coords.dtype), n_obs
        )[:, None]
        coords = jnp.tile(self.obs_coords, (n_time, 1))
        return jnp.concatenate([t_col, coords], axis=1)
