#!/usr/bin/env python
"""
Learn the inflation factor by gradient descent through the assimilation —
the reference's differentiable-DA workflow (``inf_factor`` as an
``nn.Parameter``, /root/reference/tests/unit_tests/core/test_etkf.py:105-126)
run end-to-end through the fused1d window path.

Setup: a cycled Lorenz-96 twin experiment. The loss is the analysis-mean
RMSE against the (known) truth over a short window — the quantity inflation
actually trades off (too little: filter divergence; too much: noise-fitting)
— and ``jax.grad`` flows through the RK4 forecasts AND the window LETKF
analysis (the GPU kernel's reverse rule is the plain-XLA Chebyshev twin;
docs/solvers.md "Differentiability").

Run: python examples/learn_inflation.py [--steps 30] [--cycles 10]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax
import jax.numpy as jnp

from tpu_assim.analysis import make_letkf_analysis
from tpu_assim.models import Lorenz96, RK4Integrator, integrate_trajectory
from tpu_assim.ops.localization import GaspariCohn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30, help="gradient steps")
    ap.add_argument("--cycles", type=int, default=10,
                    help="DA cycles inside the loss window")
    ap.add_argument("--ens", type=int, default=16)
    ap.add_argument("--grid", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.5)
    args = ap.parse_args()

    rng = np.random.RandomState(7)
    n_ens, n_grid = args.ens, args.grid
    n_obs = n_grid // 2
    obs_idx = jnp.asarray(np.arange(0, n_grid, 2, dtype=np.int32))
    obs_var = 0.5
    dt, n_int = 0.05, 2

    integ = RK4Integrator(Lorenz96(), dt=dt)

    # truth run + observations for the training window
    truth0 = jnp.asarray(8.0 + rng.randn(n_grid))
    spinup = integrate_trajectory(integ, truth0, 200)[-1]
    truths = integrate_trajectory(
        integ, spinup, args.cycles * n_int
    )[n_int - 1::n_int][:args.cycles]                 # [cycles, grid]
    obs_seq = jnp.asarray(
        np.asarray(truths)[:, np.asarray(obs_idx)]
        + np.sqrt(obs_var) * rng.randn(args.cycles, n_obs)
    )

    ens0 = jnp.asarray(
        np.asarray(spinup)[None, :] + 1.5 * rng.randn(n_ens, n_grid)
    )
    grid_coords = jnp.arange(n_grid, dtype=jnp.float32)[:, None]
    obs_coords = grid_coords[obs_idx]
    ovar = jnp.full((n_obs,), obs_var, jnp.float32)

    def dist(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    loc = GaspariCohn((4.0,), dist)

    def loss_fn(log_rho):
        """Mean analysis RMSE vs truth over the window; rho = exp(log_rho)
        keeps inflation positive."""
        rho = jnp.exp(log_rho)
        analyse = make_letkf_analysis(loc, rho, method="fused1d",
                                      max_obs=16, cheb_degree=16)

        def cycle(ens, obs_truth):
            obs_vals, truth = obs_truth

            def body(s, _):
                return integ.integrate(s), None

            fc, _ = jax.lax.scan(body, ens, None, length=n_int)
            ana = analyse(fc, obs_vals, ovar, obs_idx, grid_coords,
                          obs_coords)
            err = jnp.mean((jnp.mean(ana, axis=0) - truth) ** 2)
            return ana, err

        _, errs = jax.lax.scan(
            cycle, ens0.astype(jnp.float32),
            (obs_seq, truths.astype(jnp.float32)),
        )
        return jnp.mean(errs)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    log_rho = jnp.asarray(0.0)                        # rho = 1.0
    for step in range(args.steps):
        val, g = grad_fn(log_rho)
        log_rho = log_rho - args.lr * g
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {float(val):.4f}  "
                  f"rho {float(jnp.exp(log_rho)):.4f}")
    print(f"learned inflation rho = {float(jnp.exp(log_rho)):.4f}")


if __name__ == "__main__":
    main()
