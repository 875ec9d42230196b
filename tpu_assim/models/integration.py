"""
Fixed-step time integrators.

JAX rebuild of /root/reference/pytassim/model/integration/
(integrator.py:39-138, rk4.py:39-114): the generic ``integrate(state)`` API
with configurable Runge-Kutta steps/weights, plus a ``lax.scan``-based
trajectory driver that the reference lacks (it loops in Python) — on the device the
whole cycled integration compiles to one fused XLA loop.
"""

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["BaseIntegrator", "RK4Integrator", "integrate_trajectory"]


class BaseIntegrator:
    """Generic fixed-step integrator (reference: integration/integrator.py:39-138).

    Parameters
    ----------
    model : callable time-derivative ``f(state) -> dstate/dt``.
    dt : step width; positive integrates forward, negative backward.
    """

    def __init__(self, model: Callable, dt: float = 0.05):
        self._model = None
        self._dt = None
        self.model = model
        self.dt = dt

    @property
    def model(self) -> Callable:
        return self._model

    @model.setter
    def model(self, new_model: Callable):
        if not callable(new_model):
            raise TypeError("Given model is not callable!")
        self._model = new_model

    @property
    def dt(self) -> float:
        return self._dt

    @dt.setter
    def dt(self, new_dt: float):
        if not isinstance(new_dt, (float, int)):
            raise TypeError("Given time step is not a float!")
        if new_dt == 0:
            raise ValueError("Given time step is zero!")
        self._dt = new_dt

    def _calc_increment(self, state):
        raise NotImplementedError

    def integrate(self, state):
        """One step: ``state + increment`` (reference: integrator.py:110-138)."""
        return state + self._calc_increment(state)


class RK4Integrator(BaseIntegrator):
    """Classic fourth-order Runge-Kutta (reference: integration/rk4.py:39-114).
    ``steps``/``weights`` are configurable to express other RK schemes."""

    def __init__(self, model: Callable, dt: float = 0.05):
        super().__init__(model=model, dt=dt)
        self.steps = [0.0, self.dt / 2.0, self.dt / 2.0, self.dt]
        self.weights = [1.0, 2.0, 2.0, 1.0]
        self._weights_sum = sum(self.weights)
        self._weights = [w / self._weights_sum for w in self.weights]

    def __str__(self):
        return "RK4Integrator(model={0:s}, dt={1})".format(
            str(self.model), self.dt
        )

    def _estimate_slope(self, state):
        """Weighted average of the staged slopes (reference: rk4.py:92-114)."""
        averaged_slope = state * 0
        curr_slope = state * 0
        for k, ts in enumerate(self.steps):
            model_state = state + curr_slope * ts
            curr_slope = self.model(model_state)
            averaged_slope = averaged_slope + self._weights[k] * curr_slope
        return averaged_slope

    def _calc_increment(self, state):
        return self._estimate_slope(state) * self.dt


def integrate_trajectory(
    integrator: BaseIntegrator,
    state: jnp.ndarray,
    n_steps: int,
    save_every: int = 1,
) -> jnp.ndarray:
    """Integrate ``n_steps`` steps as one ``lax.scan``, saving every
    ``save_every``-th state. Returns [n_saved, *state.shape].

    This is the compiler-friendly replacement for the reference's Python
    cycling loops (e.g. examples/benchmark_letkf.py:107-122).
    """
    if n_steps % save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")

    def inner(carry, _):
        def body(s, __):
            return integrator.integrate(s), None

        new_state, _ = jax.lax.scan(body, carry, None, length=save_every)
        return new_state, new_state

    _, saved = jax.lax.scan(inner, state, None, length=n_steps // save_every)
    return saved
