"""
Lorenz '96 model.

JAX rebuild of /root/reference/pytassim/model/lorenz_96.py:39-203:
``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F`` on a periodic ring, as a
pure jnp callable over the trailing (grid) axis — batched over arbitrary
leading (ensemble/time) dims and fully jit/scan-compatible for cycled DA.
"""

from typing import Union

import jax.numpy as jnp

__all__ = ["Lorenz96"]


class Lorenz96:
    """Lorenz '96 time-derivative callable (reference: lorenz_96.py:70-203).

    Parameters
    ----------
    forcing : constant forcing F; default 8 gives chaotic behaviour.
    """

    def __init__(self, forcing: Union[float, jnp.ndarray] = 8.0):
        self.forcing = forcing

    def __str__(self):
        return "Lorenz96(F={0})".format(self.forcing)

    @staticmethod
    def _calc_advection(state: jnp.ndarray) -> jnp.ndarray:
        """Advection ``(x_{i+1} - x_{i-2}) x_{i-1}``
        (reference: lorenz_96.py:106-130)."""
        diff = jnp.roll(state, -1, axis=-1) - jnp.roll(state, 2, axis=-1)
        return diff * jnp.roll(state, 1, axis=-1)

    def __call__(self, state: jnp.ndarray) -> jnp.ndarray:
        advection = self._calc_advection(state)
        dissipation = -state
        return advection + dissipation + self.forcing
