#!/usr/bin/env python
"""
Localized IEnKS smoother on Lorenz-96 — the 4D-Var-shaped cycled use of
:func:`tpu_assim.analysis.make_lienks_step` (the jitted twin of the
class API's ``LocalizedIEnKSTransform``; reference composition:
/root/reference/pytassim/interface/variational.py:89-135 +
lienks.py:68-118 driven host-side per iteration).

Per cycle: assimilate the window-end observations into the window-START
ensemble (3 outer Gauss-Newton iterations, each propagating the
weighted ensemble through the window), then advance the analyzed
ensemble to the next window. The batched K x K SVD pair inside every
inner step is one ``jnp.linalg.svd`` call (cuSOLVER on the GPU).

Run:  python examples/lienks_l96.py  (CPU or GPU)
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp


def main():
    from tpu_assim.analysis import make_lienks_step
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.models.integration import integrate_trajectory
    from tpu_assim.ops.localization import GaspariCohn

    rng = np.random.RandomState(0)
    g, k, n_int, n_cycles = 40, 20, 4, 20
    integ = RK4Integrator(Lorenz96(), dt=0.05)

    truth = jnp.asarray(rng.normal(size=g) + 8.0)
    truth = integrate_trajectory(integ, truth, 200)[-1]
    ens = truth[None, :] + jnp.asarray(rng.normal(size=(k, g)))
    free = ens

    obs_idx = jnp.arange(0, g, 2, dtype=jnp.int32)
    obs_var = jnp.full((g // 2,), 0.25)
    grid_coords = jnp.arange(g, dtype=float)[:, None]
    obs_coords = grid_coords[obs_idx]

    def dist_fn(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    loc = GaspariCohn((4.0,), dist_fn)
    step = make_lienks_step(loc, integ, n_int, n_outer=3, tau=0.6,
                            max_obs=18, selection="window")

    rmse_da, rmse_free = [], []
    for c in range(n_cycles):
        truth_next = integrate_trajectory(integ, truth, n_int)[-1]
        obs = truth_next[obs_idx] + 0.5 * jnp.asarray(
            rng.normal(size=g // 2))
        # smoother analysis of the window START, then advance the window
        ens = step(ens, obs, obs_var, obs_idx, grid_coords, obs_coords)
        for _ in range(n_int):
            ens = integ.integrate(ens)
            free = integ.integrate(free)
        truth = truth_next
        if c >= n_cycles // 2:
            rmse_da.append(float(jnp.sqrt(jnp.mean(
                (jnp.mean(ens, 0) - truth) ** 2))))
            rmse_free.append(float(jnp.sqrt(jnp.mean(
                (jnp.mean(free, 0) - truth) ** 2))))
    print(json.dumps({
        "rmse_lienks": round(float(np.mean(rmse_da)), 3),
        "rmse_free": round(float(np.mean(rmse_free)), 3),
    }))


if __name__ == "__main__":
    main()
