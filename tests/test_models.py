"""
Toy models, integrators, and the end-to-end cycled-DA experiment.

Mirrors the reference test intent for models (tests/unit_tests/model/
test_lorenz96.py, test_lorenz84.py, test_runge_kutta4.py) plus the
scientific oracle the reference only exercises in examples: cycled LETKF
assimilation must reduce the ensemble-mean error of a Lorenz-96 run well
below the free (no-DA) ensemble.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_assim.models import (
    Lorenz84,
    Lorenz96,
    RK4Integrator,
    integrate_trajectory,
)


class TestLorenz96:
    def test_fixed_point(self):
        """x_i = F for all i is a fixed point: advection cancels, dissipation
        balances forcing."""
        model = Lorenz96(forcing=8.0)
        state = jnp.full((1, 40), 8.0)
        np.testing.assert_allclose(np.asarray(model(state)), 0.0, atol=1e-12)

    def test_hand_derivative(self):
        """Hand-computed derivative on a 5-point ring."""
        model = Lorenz96(forcing=0.0)
        x = jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0])
        # dx_i = (x_{i+1} - x_{i-2}) x_{i-1} - x_i
        expected = np.array([
            (2 - 4) * 5 - 1,
            (3 - 5) * 1 - 2,
            (4 - 1) * 2 - 3,
            (5 - 2) * 3 - 4,
            (1 - 3) * 4 - 5,
        ], dtype=float)
        np.testing.assert_allclose(np.asarray(model(x)), expected, atol=1e-12)

    def test_batched(self, rng):
        model = Lorenz96()
        batch = jnp.asarray(rng.normal(size=(3, 7, 40)))
        out = model(batch)
        assert out.shape == (3, 7, 40)
        np.testing.assert_allclose(
            np.asarray(out[1, 2]), np.asarray(model(batch[1, 2])), atol=1e-12
        )

    def test_chaos_divergence(self, rng):
        """Nearby trajectories diverge (positive Lyapunov exponent)."""
        model = Lorenz96(forcing=8.0)
        integ = RK4Integrator(model, dt=0.05)
        x0 = jnp.asarray(rng.normal(size=40) + 8.0)
        x1 = x0.at[0].add(1e-6)
        traj0 = integrate_trajectory(integ, x0, 200)
        traj1 = integrate_trajectory(integ, x1, 200)
        d_start = float(jnp.abs(traj0[0] - traj1[0]).max())
        d_end = float(jnp.abs(traj0[-1] - traj1[-1]).max())
        assert d_end > 100 * d_start


class TestLorenz84:
    def test_hand_derivative(self):
        model = Lorenz84()
        state = jnp.asarray([1.0, 2.0, 3.0])
        a, b, f, g = 0.25, 4.0, 8.0, 1.0
        expected = np.array([
            -4.0 - 9.0 - a * 1.0 + a * f,
            1.0 * 2.0 - b * 1.0 * 3.0 - 2.0 + g,
            b * 1.0 * 2.0 + 1.0 * 3.0 - 3.0,
        ])
        np.testing.assert_allclose(np.asarray(model(state)), expected,
                                   atol=1e-12)

    def test_bounded_attractor(self, rng):
        """Long trajectories stay bounded on the attractor."""
        integ = RK4Integrator(Lorenz84(), dt=0.01)
        x = jnp.asarray(rng.normal(size=(4, 3)))
        traj = integrate_trajectory(integ, x, 2000)
        assert bool(jnp.all(jnp.isfinite(traj)))
        assert float(jnp.abs(traj[-1]).max()) < 20.0


class TestRK4:
    def test_exponential_convergence_order(self):
        """Global error on dx/dt = -x scales as dt^4."""
        errs = []
        for dt in (0.2, 0.1):
            integ = RK4Integrator(lambda x: -x, dt=dt)
            x = jnp.asarray([1.0])
            n = int(round(1.0 / dt))
            for _ in range(n):
                x = integ.integrate(x)
            errs.append(abs(float(x[0]) - np.exp(-1.0)))
        order = np.log2(errs[0] / errs[1])
        assert 3.5 < order < 4.5

    def test_backward_integration_inverts(self, rng):
        integ_f = RK4Integrator(Lorenz96(), dt=0.01)
        integ_b = RK4Integrator(Lorenz96(), dt=-0.01)
        x0 = jnp.asarray(rng.normal(size=40) + 8.0)
        x1 = integ_f.integrate(x0)
        x0_back = integ_b.integrate(x1)
        np.testing.assert_allclose(np.asarray(x0_back), np.asarray(x0),
                                   rtol=1e-7, atol=1e-8)

    def test_validation(self):
        with pytest.raises(TypeError):
            RK4Integrator("not callable", dt=0.05)
        with pytest.raises(ValueError):
            RK4Integrator(lambda x: -x, dt=0.0)

    def test_trajectory_save_every(self, rng):
        integ = RK4Integrator(Lorenz96(), dt=0.01)
        x = jnp.asarray(rng.normal(size=40) + 8.0)
        full = integrate_trajectory(integ, x, 20, save_every=1)
        thin = integrate_trajectory(integ, x, 20, save_every=5)
        assert thin.shape == (4, 40)
        np.testing.assert_allclose(np.asarray(thin[-1]), np.asarray(full[-1]),
                                   atol=1e-12)

    @pytest.mark.parametrize("n_steps", [1, 4])
    @pytest.mark.parametrize("method", ["eigh", "fused1d"])
    def test_cycle_step_equals_forecast_then_analysis(self, rng, n_steps,
                                                      method):
        """make_cycle_step's forecast is the stepwise RK4Integrator (a
        scan over ``integrate``), composed with the same analysis."""
        from tpu_assim.analysis import make_cycle_step, make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        k, g, o = 8, 64, 16
        integ = RK4Integrator(Lorenz96(), dt=0.05)
        state = jnp.asarray(rng.normal(size=(k, g)) + 2.0)
        obs_idx = np.arange(0, g, g // o).astype(np.int32)
        grid = np.arange(g, dtype=np.float64)[:, None]
        args = (jnp.asarray(rng.normal(size=o)), jnp.ones(o),
                jnp.asarray(obs_idx), jnp.asarray(grid),
                jnp.asarray(grid[obs_idx]))
        loc = GaspariCohn((4.0,), lambda gc, oi: jnp.abs(
            oi[:, 1] - gc[1])[None, :])
        opts = dict(method=method, max_obs=8)
        cyc = make_cycle_step(integ, n_steps, loc, 1.1, **opts)(state, *args)
        ref = state
        for _ in range(n_steps):
            ref = integ.integrate(ref)
        ana = make_letkf_analysis(loc, 1.1, **opts)(ref, *args)
        # fused1d computes in float32
        tol = 1e-10 if method == "eigh" else 1e-5
        np.testing.assert_allclose(np.asarray(cyc), np.asarray(ana),
                                   rtol=tol, atol=tol)


class TestCycledDA:
    """End-to-end: cycled LETKF on Lorenz-96 beats the free ensemble (the
    composition the reference builds by hand, SURVEY §3.5)."""

    def test_letkf_cycle_reduces_rmse(self, rng):
        from tpu_assim.analysis import make_cycle_step
        from tpu_assim.ops.localization import GaspariCohn, periodic_distance

        len_grid, ens_size, n_cycles, n_int = 40, 20, 30, 4
        dt, obs_var_val = 0.05, 0.5
        model = Lorenz96(forcing=8.0)
        integ = RK4Integrator(model, dt=dt)

        # spin up truth
        truth = jnp.asarray(rng.normal(size=len_grid) + 8.0)
        truth = integrate_trajectory(integ, truth, 200)[-1]

        # initial ensemble: truth + noise
        ens = truth[None, :] + jnp.asarray(
            rng.normal(size=(ens_size, len_grid))
        )
        free = ens

        obs_idx = jnp.asarray(np.arange(0, len_grid, 2, dtype=np.int32))
        obs_var = jnp.full((len_grid // 2,), obs_var_val)
        grid_coords = jnp.asarray(np.arange(len_grid, dtype=float))[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist_fn(gc, oi):
            d = jnp.abs(oi[:, 1] - gc[1])
            return jnp.minimum(d, len_grid - d)[None, :]

        loc = GaspariCohn((4.0,), dist_fn)
        step = make_cycle_step(integ, n_int, loc, inf_factor=1.1)

        rmse_da, rmse_free = [], []
        for c in range(n_cycles):
            truth = integrate_trajectory(integ, truth, n_int)[-1]
            obs = truth[obs_idx] + jnp.asarray(
                rng.normal(size=len_grid // 2) * np.sqrt(obs_var_val)
            )
            ens = step(ens, obs, obs_var, obs_idx, grid_coords, obs_coords)
            for _ in range(n_int):
                free = integ.integrate(free)
            if c >= n_cycles // 2:  # after spin-up
                rmse_da.append(float(jnp.sqrt(jnp.mean(
                    (jnp.mean(ens, 0) - truth) ** 2))))
                rmse_free.append(float(jnp.sqrt(jnp.mean(
                    (jnp.mean(free, 0) - truth) ** 2))))
        assert np.mean(rmse_da) < 0.5 * np.mean(rmse_free)
        # analysis should track the truth within ~2x the obs error
        assert np.mean(rmse_da) < 2.0 * np.sqrt(obs_var_val)
