#!/usr/bin/env python
"""
Cycled-DA decomposition of bench config 6 (forecast + analysis): measure
each component with the same fori_loop two-point-slope discipline as
bench.py:

  A  analysis only (geometry-static fused1d, the config-2/6 analysis)
  F  forecast only (4 RK4 steps, a scan over ``integrate``)
  C  full cycle (make_cycle_step, geometry static)
  C0 cycle with n_int_steps=0 (analysis through the cycle plumbing —
     isolates obs-gather/normalization glue from the forecast)

Prints one JSON line with all slopes (ms) and the implied glue.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import _chain_time, build_workload, exact_nb


def main():
    from tpu_assim.device import require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()
    from tpu_assim.analysis import make_cycle_step, make_letkf_analysis
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_1d

    def dist_fn(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    g, o = 10000, 1000
    w_np = build_workload(40, g, o)
    w = tuple(jnp.asarray(a) for a in w_np[:3])
    nb = exact_nb(max_in_support_1d(w_np[5][:, 0], w_np[4][:, 0], 20.0))
    loc = GaspariCohn((20.0,), dist_fn)
    geom = (w_np[3], w_np[4], w_np[5])
    integ = RK4Integrator(Lorenz96(), dt=0.05)

    analyse = make_letkf_analysis(loc, inf_factor=1.1, method="fused1d",
                                  max_obs=nb, cheb_degree=12,
                                  geometry=geom)

    @jax.jit
    def step_a(acc, *a):
        return jnp.sum(analyse(a[0] + acc * 1e-9, *a[1:])) * 1e-12

    @jax.jit
    def step_f(acc, *a):
        out = jax.lax.scan(lambda s, _: (integ.integrate(s), None),
                           a[0] + acc * 1e-9, None, length=4)[0]
        return jnp.sum(out) * 1e-12

    cyc = make_cycle_step(integ, 4, loc, inf_factor=1.1, method="fused1d",
                          max_obs=nb, cheb_degree=12, geometry=geom)

    @jax.jit
    def step_c(acc, *a):
        return jnp.sum(cyc(a[0] + acc * 1e-9, *a[1:])) * 1e-12

    cyc0 = make_cycle_step(integ, 0, loc, inf_factor=1.1, method="fused1d",
                           max_obs=nb, cheb_degree=12, geometry=geom)

    @jax.jit
    def step_c0(acc, *a):
        return jnp.sum(cyc0(a[0] + acc * 1e-9, *a[1:])) * 1e-12

    # throwaway first timing (fresh-process warm-up)
    _chain_time(step_a, w, reps=40, r1=10, trials=1)
    t_a = _chain_time(step_a, w, reps=200, r1=40, trials=4)
    t_f = _chain_time(step_f, (w[0],), reps=400, r1=80, trials=4)
    t_c = _chain_time(step_c, w, reps=200, r1=40, trials=4)
    t_c0 = _chain_time(step_c0, w, reps=200, r1=40, trials=4)
    print(json.dumps({
        "analysis_ms": round(t_a * 1e3, 4),
        "forecast4_ms": round(t_f * 1e3, 4),
        "cycle_ms": round(t_c * 1e3, 4),
        "cycle_nint0_ms": round(t_c0 * 1e3, 4),
        "glue_ms_cycle_minus_parts": round((t_c - t_a - t_f) * 1e3, 4),
        "glue_ms_nint0_minus_analysis": round((t_c0 - t_a) * 1e3, 4),
        "cycles_per_s": round(1.0 / t_c, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
