"""
Lorenz-96 observation operators
(reference: /root/reference/pytassim/obs_ops/lorenz_96/identity.py:40-95 and
bernoulli.py:40-90).
"""

from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from tpu_assim.obs_ops.base_ops import BaseOperator
from tpu_assim.state import EnsembleState

__all__ = ["IdentityOperator", "BernoulliOperator"]


class IdentityOperator(BaseOperator):
    """Identity operator: observed grid points equal observations
    (reference: identity.py:40-95).

    Parameters
    ----------
    obs_points : None (observe all points), int (draw that many points with
        ``random_state``), or an explicit list of grid indices.
    """

    def __init__(
        self,
        obs_points: Union[None, int, Sequence[int]] = None,
        len_grid: int = 40,
        random_state: Optional[np.random.RandomState] = None,
    ):
        super().__init__(len_grid=len_grid, random_state=random_state)
        self._obs_points = None
        self._sel_obs_points = None
        self.obs_points = obs_points

    @property
    def obs_points(self):
        return self._obs_points

    @obs_points.setter
    def obs_points(self, points):
        """(reference: identity.py:66-78)"""
        if isinstance(points, (int, float)):
            rs = self.random_state or np.random
            self._sel_obs_points = np.sort(
                rs.choice(self.len_grid, size=int(points), replace=False)
            )
        elif points is None:
            self._sel_obs_points = np.arange(self.len_grid)
        else:
            self._sel_obs_points = np.asarray(points)
        self._obs_points = points

    def _select_var(self, in_state: EnsembleState) -> jnp.ndarray:
        """Select variable 'x' if present, else the first variable
        (reference: identity.py:80-82 ``sel(var_name='x')``).
        Returns [time, ens, grid]."""
        if "x" in in_state.var_names:
            v = in_state.var_names.index("x")
        else:
            v = 0
        return in_state.data[v]

    def obs_op(self, in_state: EnsembleState, *args, **kwargs) -> jnp.ndarray:
        values = self._select_var(in_state)
        return jnp.take(values, jnp.asarray(self._sel_obs_points), axis=-1)

    def jax_operator(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        """One-hot linear map (the reference freezes an ``nn.Linear``,
        identity.py:85-95)."""
        h_matrix = jnp.zeros((len(self._sel_obs_points), self.len_grid))
        h_matrix = h_matrix.at[
            jnp.arange(len(self._sel_obs_points)),
            jnp.asarray(self._sel_obs_points),
        ].set(1.0)

        def operator(x: jnp.ndarray) -> jnp.ndarray:
            return jnp.einsum("...g,og->...o", x, h_matrix,
                              precision=jax.lax.Precision.HIGHEST)

        return operator


class BernoulliOperator(IdentityOperator):
    """Nonlinear operator ``sigmoid(x - shift)`` on the observed points
    (reference: bernoulli.py:40-90)."""

    def __init__(
        self,
        shift: float = 5.0,
        obs_points: Union[None, int, Sequence[int]] = None,
        len_grid: int = 40,
        random_state: Optional[np.random.RandomState] = None,
    ):
        super().__init__(
            obs_points=obs_points, len_grid=len_grid, random_state=random_state
        )
        self.shift = shift

    def obs_op(self, in_state: EnsembleState, *args, **kwargs) -> jnp.ndarray:
        obs_state = super().obs_op(in_state, *args, **kwargs)
        return jax.nn.sigmoid(obs_state - self.shift)

    def jax_operator(self) -> Callable[[jnp.ndarray], jnp.ndarray]:
        linear = super().jax_operator()

        def operator(x: jnp.ndarray) -> jnp.ndarray:
            return jax.nn.sigmoid(linear(x) - self.shift)

        return operator
