#!/usr/bin/env python
"""
Benchmark driver: the reference's LETKF workload
(examples/benchmark_letkf.py:49-77 of pytassim) on the GPU.

Workload (identical shapes/parameters to the reference defaults): 40-member
ensemble, 10 000 grid points, 1 000 point observations at
``linspace(0, len_grid)`` locations, obs variance 1, Gaspari-Cohn radius 20,
inflation 1.1, ``abs(x - y)`` distance. Metric: analysis grid-points/s.

Baseline: the reference publishes no numbers (BASELINE.md), so ``vs_baseline``
is measured live against a faithful numpy re-enactment of pytassim's
execution model — a per-gridpoint Python loop with ragged masked obs subsets
and a K x K eigendecomposition per column (what
pytassim/interface/letkf.py:127-143 + core/etkf.py:57-77 do inside
np.vectorize), run on this host's CPU.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline", ...} with
the device's platform, kind and count. ``python bench.py --all`` prints one
such line per configuration. Both raise when JAX finds no GPU: a CPU timing
is not a device number.
"""

import json
import time

import numpy as np


def build_workload(ens_size=40, len_grid=10000, nr_obs=1000, dtype="float32"):
    rnd = np.random.RandomState(42)
    state = rnd.normal(size=(ens_size, len_grid)).astype(dtype)
    obs_locs = np.linspace(0, len_grid, num=nr_obs, endpoint=False)
    obs_idx = np.rint(obs_locs).astype(np.int32) % len_grid
    obs_vals = rnd.normal(size=(nr_obs,)).astype(dtype)
    obs_var = np.ones(nr_obs, dtype=dtype)
    grid_coords = np.arange(len_grid, dtype=dtype)[:, None]
    obs_coords = obs_locs.astype(dtype)[:, None]
    return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords


def gc_weights_numpy(dists, radius):
    """Gaspari-Cohn taper (pytassim/localization/gaspari_cohn.py:77-95)."""
    z = dists / radius
    w = np.zeros_like(z)
    outer = (z >= 1) & (z < 2)
    inner = z < 1
    zo = z[outer]
    w[outer] = (
        zo**5 / 12 - 0.5 * zo**4 + 0.625 * zo**3 + 5 / 3 * zo**2
        - 5 * zo + 4 - 2 / (3 * zo)
    )
    zi = z[inner]
    w[inner] = -0.25 * zi**5 + 0.5 * zi**4 + 0.625 * zi**3 - 5 / 3 * zi**2 + 1
    return w


def numpy_reference_letkf(state, obs_vals, obs_var, obs_idx, grid_coords,
                          obs_coords, radius=20.0, inf_factor=1.1,
                          max_points=None):
    """pytassim-style per-gridpoint loop (the reference execution model)."""
    ens_size, len_grid = state.shape
    rcinv = 1.0 / np.sqrt(obs_var)
    ens_obs = state[:, obs_idx]
    mean_obs = ens_obs.mean(axis=0)
    perts = (ens_obs - mean_obs) * rcinv
    innov = (obs_vals - mean_obs) * rcinv
    n_points = len_grid if max_points is None else min(max_points, len_grid)
    analysis = np.empty((ens_size, n_points), dtype=np.float64)
    state_mean = state.mean(axis=0)
    state_perts = state - state_mean
    reg = (ens_size - 1) / inf_factor
    for g in range(n_points):
        d = np.abs(grid_coords[g, 0] - obs_coords[:, 0])
        w = gc_weights_numpy(d, radius)
        use = w > 1e-5
        sw = np.sqrt(w[use])
        z = perts[:, use] * sw
        y = innov[use] * sw
        gram = z @ z.T
        evals, evects = np.linalg.eigh(gram)
        evals = np.clip(evals, 0, None) + reg
        einv = 1 / evals
        cov = (evects * einv) @ evects.T
        w_mean = cov @ (z @ y)
        w_perts = (evects * np.sqrt((ens_size - 1) * einv)) @ evects.T
        wmat = w_mean[:, None] + w_perts
        analysis[:, g] = state_mean[g] + state_perts[:, g] @ wmat
    return analysis, n_points


def oracle_columns(state, perts, innov, weights_fn, cols, inf_factor=1.1):
    """Exact f64 per-column eigh analysis at the given columns.

    ``weights_fn(g) -> [o] taper weights`` defines the localization;
    perts/innov are the R^{-1/2}-normalized obs-space arrays (f64).
    """
    k = state.shape[0]
    reg = (k - 1) / inf_factor
    mean = state.mean(axis=0)
    sp = state - mean
    out = np.empty((k, len(cols)))
    for j, g in enumerate(cols):
        w = weights_fn(g)
        use = w > 1e-5
        sw = np.sqrt(w[use])
        z = perts[:, use] * sw
        y = innov[use] * sw
        gram = z @ z.T
        evals, evects = np.linalg.eigh(gram)
        evals = np.clip(evals, 0, None) + reg
        einv = 1.0 / evals
        cov = (evects * einv) @ evects.T
        w_mean = cov @ (z @ y)
        w_perts = (evects * np.sqrt((k - 1) * einv)) @ evects.T
        out[:, j] = mean[g] + sp[:, g] @ (w_mean[:, None] + w_perts)
    return out


def exact_nb(worst: int, mult: int = 4, floor: int = 8) -> int:
    """Smallest window size that is EXACT for the workload: the host-side
    in-support maximum (max_in_support_1d/_2d) rounded up to a multiple of
    ``mult``. Every per-column solve tensor scales with nb, so the window
    is sized to the workload, not to a default. The strict guards verify
    the bound at run time (NaN-poison + host-side raise on violation), so
    this is a measured configuration, not an approximation."""
    return max(-(-worst // mult) * mult, floor)


def _chain_time(step, args, reps=20, trials=3, r1=None):
    """True steady-state per-step device seconds for ``step(acc, *args)``.

    Runs ``r1`` and ``reps`` data-dependent chained steps inside ONE jitted
    ``fori_loop`` each and returns the two-point slope
    ``(T(reps) - T(r1)) / (reps - r1)``: every fixed per-invocation cost —
    jit dispatch, program launch, the final scalar device-to-host copy —
    cancels exactly, leaving the per-analysis device time. The loop carry feeds each step's scalar output back into the next
    step's input, so XLA can neither hoist nor overlap reps.

    ``args`` are passed as jit arguments, NOT closed over — closures would
    bake hundreds of MB of constants into the compiled program.
    """
    import jax
    import jax.numpy as jnp
    import numpy as _np

    if r1 is None:
        r1 = max(reps // 5, 1)

    @jax.jit
    def looped(acc, n, *a):
        def body(_, x):
            return step(x, *a)
        return jax.lax.fori_loop(0, n, body, acc)

    acc0 = jnp.asarray(0.0, jnp.float32)
    n1 = jnp.asarray(r1, jnp.int32)
    n2 = jnp.asarray(reps, jnp.int32)
    _np.asarray(looped(acc0, n1, *args))  # warmup/compile (shared trace)
    # Per-trial PAIRED slopes (t_lo, t_hi measured back to back), then the
    # MEDIAN slope over trials: differencing independent minima can pair a
    # lucky t_lo with an unlucky t_hi and produce a noisy or even negative
    # slope on tiny rep spans, and a min over paired slopes is still
    # biased low whenever one t_lo measurement catches a noise spike. The
    # median is robust against outliers in both directions. Non-positive
    # slopes are discarded.
    slopes = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _np.asarray(looped(acc0, n1, *args))
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        _np.asarray(looped(acc0, n2, *args))
        t_hi = time.perf_counter() - t0
        slope = (t_hi - t_lo) / (reps - r1)
        if slope > 0:
            slopes.append(slope)
    if not slopes:
        raise RuntimeError(
            "no positive timing slope measured — raise reps or trials"
        )
    return float(_np.median(slopes))


def run_all_configs():
    """The BASELINE.json workloads and the extra cells, one JSON line
    each."""
    import jax
    import jax.numpy as jnp

    from tpu_assim.device import require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()

    from tpu_assim.analysis import make_etkf_analysis, make_letkf_analysis
    from tpu_assim.ops.ketkf import ketkf_weights
    from tpu_assim.ops.kernels import GaussKernel
    from tpu_assim.ops.localization import GaspariCohn

    import sys

    def progress(msg):
        print(msg, file=sys.stderr, flush=True)

    results = []

    def dist_fn(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    def emit(row):
        row = {**row, "device": device}
        results.append(row)
        print(json.dumps(row), flush=True)

    # -- config 1: ETKF global, Lorenz-96 scale (40 vars, 20 members) -----
    w1 = tuple(jnp.asarray(a) for a in build_workload(20, 40, 20))
    etkf = make_etkf_analysis(1.1)

    @jax.jit
    def step1(acc, *w):
        return jnp.sum(etkf(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 1: etkf global...")
    t1 = _chain_time(step1, w1, reps=400)
    emit({"metric": "etkf_global_analyses_per_s",
          "value": round(1.0 / t1, 1),
          "unit": "analyses/s (ens=20, grid=40, obs=20)"})

    # -- config 2: LETKF benchmark workload (the headline metric) ---------
    from tpu_assim.ops.window import (
        max_in_support_1d, max_in_support_2d)

    w2 = tuple(jnp.asarray(a) for a in build_workload(40, 10000, 1000))
    loc2 = GaspariCohn((20.0,), dist_fn)
    nb2 = exact_nb(max_in_support_1d(w2[5][:, 0], w2[4][:, 0], 20.0))
    letkf = make_letkf_analysis(loc2, inf_factor=1.1, method="fused1d",
                                max_obs=nb2, cheb_degree=12)

    @jax.jit
    def step2(acc, *w):
        return jnp.sum(letkf(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 2: letkf bench...")
    t2 = _chain_time(step2, w2, reps=200)
    emit({"metric": "letkf_analysis_grid_points_per_s",
          "value": round(10000 / t2, 1),
          "unit": "grid-points/s (ens=40, grid=10000, obs=1000, GC r=20)"})

    # -- config 3: domain-decomposed LETKF over the local device mesh -----
    from tpu_assim.parallel.halo import (
        halo_letkf_analysis, halo_width_for, shard_observations)
    from tpu_assim.parallel.mesh import make_grid_mesh

    n_dev = len(jax.devices())
    g3 = 10240
    w3 = build_workload(40, g3, 1024)
    mesh = make_grid_mesh(n_dev)
    vals, var, lidx, coords, valid, _ = shard_observations(
        w3[1], w3[2], w3[3], w3[5], g3, n_dev)
    # windowed local solve: each shard runs the window analysis on its
    # sorted halo candidates — no dense taper / top_k.
    # max_obs sized to the exact in-support maximum incl. pad slots
    # (obs evenly spread -> balanced shard counts, no pads on 1 device);
    # the builder's strict precheck raises if the sizing were wrong.
    from tpu_assim.parallel.halo import _halo_max_in_support
    nb3 = exact_nb(_halo_max_in_support(coords, valid, n_dev, 20.0,
                                        "gc2", 1e-5, 1))
    halo = halo_letkf_analysis(
        mesh, GaspariCohn((20.0,), dist_fn), max_obs=nb3,
        halo_width=halo_width_for(20.0, g3 / n_dev), inf_factor=1.1,
        local_method="window", cheb_degree=12,
    )
    h_args = tuple(jnp.asarray(a)
                   for a in (w3[0], vals, var, lidx, coords, valid, w3[4]))

    @jax.jit
    def step3(acc, *w):
        return jnp.sum(halo(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 3: halo sharded...")
    t3 = _chain_time(step3, h_args, reps=100)
    emit({"metric": "letkf_halo_sharded_grid_points_per_s",
          "value": round(g3 / t3, 1),
          "unit": "grid-points/s over {0} device(s) "
                  "(obs-sharded, ring halo)".format(n_dev)})

    # -- config 4: kernelized ETKF (Gauss kernel) --------------------------
    w4 = tuple(jnp.asarray(a) for a in build_workload(40, 10000, 1000))
    kernel = GaussKernel(lengthscale=2.0)

    @jax.jit
    def step4(acc, *w):
        state = w[0] + acc * 1e-9
        ens_obs = jnp.take(state, w[3], axis=-1)
        rcinv = 1.0 / jnp.sqrt(w[2])
        mean = jnp.mean(ens_obs, axis=0, keepdims=True)
        perts = (ens_obs - mean) * rcinv
        innov = ((w[1] - mean[0]) * rcinv)[None, :]
        weights = ketkf_weights(perts, innov, kernel, 1.1)
        sm = jnp.mean(state, axis=0, keepdims=True)
        out = sm + jnp.einsum("kg,km->mg", state - sm, weights,
                              precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(out) * 1e-12

    progress("config 4: ketkf...")
    t4 = _chain_time(step4, w4, reps=100)
    emit({"metric": "ketkf_global_grid_points_per_s",
          "value": round(10000 / t4, 1),
          "unit": "grid-points/s (Gauss kernel, ens=40, grid=10000,"
                  " obs=1000)"})

    # -- config 5: large cycled-DA scale: 100 members, ~1M columns --------
    g5, o5 = 1 << 20, 1 << 16
    w5 = tuple(jnp.asarray(a) for a in build_workload(100, g5, o5))
    # Nontrivial batched obs operator at the 1M scale: each observation is
    # a 4-column local mean around its location (H beyond pure indexing,
    # applied to all 2^16 obs inside the jitted analysis — the reference
    # operator contract, pytassim/obs_ops/base_ops.py:42).
    import numpy as _np5

    idx5 = _np5.asarray(w5[3])
    # numpy constant (NOT jnp): a device-resident closure constant is
    # copied back to the host at trace time
    stencil5 = _np5.stack(
        [(idx5 + s) % g5 for s in range(4)], axis=1).astype(_np5.int32)

    def h5(state_data):
        return jnp.mean(jnp.take(state_data, stencil5, axis=-1), axis=-1)

    nb5 = exact_nb(max_in_support_1d(w5[5][:, 0], w5[4][:, 0], 20.0))
    letkf5 = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), inf_factor=1.1, method="fused1d",
        max_obs=nb5, obs_operator=h5,
    )

    # -- bonus: full cycled-DA throughput (forecast + fused analysis) ------
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.analysis import make_cycle_step

    g6, o6 = 10000, 1000
    w6_np = build_workload(40, g6, o6)
    w6 = tuple(jnp.asarray(a) for a in w6_np[:3])
    nb6 = exact_nb(max_in_support_1d(w6_np[5][:, 0], w6_np[4][:, 0], 20.0))
    # static geometry: the obs network and grid are fixed across cycles,
    # so they bind as XLA constants and the selection prologue constant-
    # folds — each cycle pays forecast + solve time only
    cyc = make_cycle_step(
        RK4Integrator(Lorenz96(), dt=0.05), 4,
        GaspariCohn((20.0,), dist_fn), inf_factor=1.1,
        method="fused1d", max_obs=nb6, cheb_degree=12,
        geometry=(w6_np[3], w6_np[4], w6_np[5]),
    )

    @jax.jit
    def step6(acc, *w):
        return jnp.sum(cyc(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 6: cycle throughput...")
    t6 = _chain_time(step6, w6, reps=100)
    emit({"metric": "da_cycles_per_s",
          "value": round(1.0 / t6, 2),
          "unit": "forecast(4xRK4)+analysis cycles/s (ens=40, grid=10000,"
                  " obs=1000)"})

    @jax.jit
    def step5(acc, *w):
        return jnp.sum(letkf5(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 5: large letkf...")
    t5 = _chain_time(step5, w5, reps=6, r1=2, trials=2)
    emit({"metric": "letkf_large_grid_points_per_s",
          "value": round(g5 / t5, 1),
          "unit": "grid-points/s (ens=100, grid=2^20, obs=2^16, GC r=20,"
                  " 4-pt-mean batched obs operator)"})

    # -- config 7: 2-D domain via the fused2d window analysis -------------
    from tpu_assim.ops.window import required_obs_block_2d

    nr = nc = 128
    g7, o7 = nr * nc, 1024
    rnd7 = np.random.RandomState(42)
    yy, xx = np.meshgrid(np.arange(nr, dtype="f4"),
                         np.arange(nc, dtype="f4"), indexing="ij")
    grid_xy7 = np.stack([xx.ravel(), yy.ravel()], 1)
    obs_cells7 = rnd7.choice(g7, size=o7, replace=False).astype(np.int32)
    obs_xy7 = grid_xy7[obs_cells7]
    w7 = (
        jnp.asarray(rnd7.normal(size=(40, g7)).astype("f4")),
        jnp.asarray(rnd7.normal(size=o7).astype("f4")),
        jnp.asarray(np.ones(o7, dtype="f4")),
        jnp.asarray(obs_cells7),
        jnp.asarray(grid_xy7),
        jnp.asarray(obs_xy7),
    )

    def dist2(gc, oi):
        return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                          jnp.abs(oi[:, 2] - gc[2])], 0)

    # radius 4: nb sized to the exact per-column band/x-cutoff maximum
    # (max_in_support_2d; the strict guards verify) — every solve tensor
    # scales with nb, so the conservative 48 was pure overhead
    blk7 = required_obs_block_2d(obs_xy7[:, 1], grid_xy7[:, 1], 4.0)
    nb7 = exact_nb(max_in_support_2d(obs_xy7, grid_xy7, 4.0, 4.0))
    # degree 12 measured indistinguishable from 16 at this conditioning
    # (both 2.3e-7 vs the f64 oracle — docs/solvers.md accuracy budget)
    letkf7 = make_letkf_analysis(
        GaspariCohn((4.0, 4.0), dist2), inf_factor=1.1, method="fused2d",
        max_obs=nb7, cheb_degree=12, obs_block=blk7,
    )

    @jax.jit
    def step7(acc, *w):
        return jnp.sum(letkf7(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 7: 2-D fused2d...")
    t7 = _chain_time(step7, w7, reps=100)
    emit({"metric": "letkf_2d_fused_grid_points_per_s",
          "value": round(g7 / t7, 1),
          "unit": "grid-points/s (2-D 128x128 grid, ens=40, obs=1024,"
                  " GC rx=ry=4, fused2d)"})

    # -- config 8: production-scale 2-D (1024x1024, 1e5 obs, x-strips) ----
    from tpu_assim.analysis import make_strip_letkf_2d

    nr8 = nc8 = 1024
    g8, o8 = nr8 * nc8, 100_000
    rnd8 = np.random.RandomState(42)
    yy8, xx8 = np.meshgrid(np.arange(nr8, dtype="f4"),
                           np.arange(nc8, dtype="f4"), indexing="ij")
    grid_xy8 = np.stack([xx8.ravel(), yy8.ravel()], 1)
    cells8 = np.sort(rnd8.choice(g8, size=o8, replace=False)
                     ).astype(np.int32)
    obs_xy8 = grid_xy8[cells8]
    w8 = (
        jnp.asarray(rnd8.normal(size=(40, g8)).astype("f4")),
        jnp.asarray(rnd8.normal(size=o8).astype("f4")),
        jnp.asarray(np.ones(o8, dtype="f4")),
    )
    letkf8 = make_strip_letkf_2d(
        GaspariCohn((4.0, 4.0), dist2), (cells8, grid_xy8, obs_xy8),
        n_strips=16, inf_factor=1.1, cheb_degree=16,
    )

    @jax.jit
    def step8(acc, *w):
        return jnp.sum(letkf8(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 8: production 2-D strips (compile ~5-10 min)...")
    t8 = _chain_time(step8, w8, reps=8, r1=2, trials=2)
    emit({"metric": "letkf_2d_production_grid_points_per_s",
          "value": round(g8 / t8, 1),
          "unit": "grid-points/s (2-D 1024x1024 grid, ens=40, obs=1e5,"
                  " GC rx=ry=4, x-strip fused2d, auto window)"})

    # -- config 9: localized IEnKS (the iterative-smoother family) --------
    # The flagship iterative smoother (reference interface/lienks.py:
    # 31-163): 2 outer Gauss-Newton iterations over an L96 forecast
    # window, each inner step running TWO batched [g, 40, 40] SVDs.
    from tpu_assim.analysis import make_lienks_step
    from tpu_assim.models import Lorenz96, RK4Integrator

    g9, o9 = 10000, 1000
    w9 = tuple(jnp.asarray(a) for a in build_workload(40, g9, o9))
    nb9 = exact_nb(max_in_support_1d(w9[5][:, 0], w9[4][:, 0], 20.0))
    lienks = make_lienks_step(
        GaspariCohn((20.0,), dist_fn), RK4Integrator(Lorenz96(), dt=0.05),
        4, n_outer=2, tau=1.0, max_obs=nb9, selection="window",
    )

    @jax.jit
    def step9(acc, *w):
        return jnp.sum(lienks(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 9: localized IEnKS...")
    t9 = _chain_time(step9, w9, reps=10, r1=2, trials=2)
    emit({"metric": "lienks_grid_points_per_s",
          "value": round(g9 / t9, 1),
          "unit": "grid-points/s (localized IEnKS-Transform, ens=40, "
                  "grid=10000, obs=1000, GC r=20, 2 outer iter, "
                  "L96 4xRK4 window)"})

    # -- config 10: 4-D smoother conditioning (stacked obs times) ---------
    # The reference's long-axis mechanism is obs-time stacking
    # (pytassim/interface/base.py:222-241): 4 obs times over the same
    # network quadruple the per-column obs load, pushing the solve
    # spectrum into the high-degree Chebyshev regime the auto-degree
    # logic is built for (docs/solvers.md).
    n_t10 = 4
    g10, o_b10 = 10000, 1000
    w10b = build_workload(40, g10, o_b10)
    rnd10 = np.random.RandomState(7)
    oc10 = np.repeat(w10b[5], n_t10, axis=0)       # sorted stays sorted
    oi10 = np.repeat(w10b[3], n_t10)
    ov10 = rnd10.normal(size=o_b10 * n_t10).astype("f4")
    var10 = np.ones(o_b10 * n_t10, dtype="f4")
    nb10 = exact_nb(max_in_support_1d(oc10[:, 0], w10b[4][:, 0], 20.0))
    # auto degree exactly as the class API measures it
    # (interface/letkf.py:_auto_cheb_degree): spectral bound from the
    # max nb10-consecutive sum of ||z_o||^2 over the sorted stacked obs
    from tpu_assim.ops.window import cheb_degree_for

    znorm = (w10b[0][:, oi10] - w10b[0][:, oi10].mean(0)) ** 2
    cs10 = np.concatenate([[0.0], np.cumsum(znorm.sum(0))])
    width10 = min(nb10, len(oi10))
    tr_max10 = float((cs10[width10:] - cs10[:-width10]).max())
    deg10 = cheb_degree_for(1.0 + tr_max10 / (39.0 / 1.1))
    w10 = tuple(jnp.asarray(a) for a in
                (w10b[0], ov10, var10, oi10, w10b[4], oc10))
    letkf10 = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), inf_factor=1.1, method="fused1d",
        max_obs=nb10, cheb_degree=deg10,
    )

    @jax.jit
    def step10(acc, *w):
        return jnp.sum(letkf10(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress(f"config 10: 4-D smoother stack (auto degree {deg10})...")
    t10 = _chain_time(step10, w10, reps=50, r1=10, trials=3)
    emit({"metric": "letkf_smoother4d_grid_points_per_s",
          "value": round(g10 / t10, 1),
          "unit": "grid-points/s (4 stacked obs times -> 4000 obs, "
                  "ens=40, grid=10000, GC r=20, auto Chebyshev degree "
                  f"{deg10})",
          "auto_cheb_degree": int(deg10)})

    # -- config 11: localized kernelized ETKF at grid scale ---------------
    # The LKETKF O(g*nb) fast path (interface/lketkf.py) with a Gauss
    # kernel: per-column kernelized solve over sorted-window obs
    # neighborhoods, whose batched [g, 40, 40] eigendecomposition is the
    # eigh consumer at grid scale.
    from tpu_assim.interface.lketkf import _lketkf_solve

    g11, o11 = 10000, 1000
    w11 = tuple(jnp.asarray(a) for a in build_workload(40, g11, o11))
    loc11 = GaspariCohn((20.0,), dist_fn)
    nb11 = exact_nb(max_in_support_1d(w11[5][:, 0], w11[4][:, 0], 20.0))
    kern11 = GaussKernel(lengthscale=2.0)
    hp = jax.lax.Precision.HIGHEST

    @jax.jit
    def step11(acc, *w):
        state = w[0] + acc * 1e-9
        ens_obs = jnp.take(state, w[3], axis=-1)
        rcinv = 1.0 / jnp.sqrt(w[2])
        mean = jnp.mean(ens_obs, axis=0, keepdims=True)
        perts = (ens_obs - mean) * rcinv
        innov = (w[1] - mean[0]) * rcinv
        gi = jnp.concatenate(
            [jnp.zeros((w[4].shape[0], 1), w[4].dtype), w[4]], axis=1)
        oi = jnp.concatenate(
            [jnp.zeros((w[5].shape[0], 1), w[5].dtype), w[5]], axis=1)
        weights = _lketkf_solve(
            loc11, None, "eigh", 25, nb11, "window", True, kern11,
            perts, innov, gi, oi, jnp.asarray(1.1, perts.dtype),
        )
        sm = jnp.mean(state, axis=0)
        out = sm[None, :] + jnp.einsum(
            "kg,gkm->mg", state - sm[None, :], weights, precision=hp)
        return jnp.sum(out) * 1e-12

    progress("config 11: localized KETKF (eigh weights)...")
    t11 = _chain_time(step11, w11, reps=20, r1=4, trials=3)

    # the fused vector-only Chebyshev path: no [g, k, k]
    # weights, no eigendecomposition — ops/ketkf.py:ketkf_cheb_analysis
    # via the class-API solve (interface/lketkf.py)
    from tpu_assim.interface.lketkf import _lketkf_cheb_analysis

    @jax.jit
    def step11c(acc, *w):
        state = w[0] + acc * 1e-9
        ens_obs = jnp.take(state, w[3], axis=-1)
        rcinv = 1.0 / jnp.sqrt(w[2])
        mean = jnp.mean(ens_obs, axis=0, keepdims=True)
        perts = (ens_obs - mean) * rcinv
        innov = (w[1] - mean[0]) * rcinv
        gi = jnp.concatenate(
            [jnp.zeros((w[4].shape[0], 1), w[4].dtype), w[4]], axis=1)
        oi = jnp.concatenate(
            [jnp.zeros((w[5].shape[0], 1), w[5].dtype), w[5]], axis=1)
        out = _lketkf_cheb_analysis(
            loc11, None, nb11, "window", True, 10, kern11,
            perts, innov, gi, oi, jnp.asarray(1.1, perts.dtype),
            state[None, None],
        )
        return jnp.sum(out) * 1e-12

    progress("config 11b: localized KETKF (fused Chebyshev)...")
    t11c = _chain_time(step11c, w11, reps=100, r1=20, trials=3)
    emit({"metric": "lketkf_grid_points_per_s",
          "value": round(g11 / t11c, 1),
          "unit": "grid-points/s (localized KETKF, Gauss kernel, ens=40, "
                  "grid=10000, obs=1000, GC r=20, window neighborhoods, "
                  "fused vector-only Chebyshev — no weights, no eigh)",
          "eigh_weights_grid_points_per_s": round(g11 / t11, 1),
          "vs_eigh_weights": round(t11 / t11c, 2)})

    # -- config 12: correlated observation errors (full [o, o] R) ---------
    # The reference's correlated-R contract (observation.py:249-250
    # torch.cholesky) at the benchmark scale: one [1000, 1000] Cholesky +
    # two triangular solves whiten the obs space, then the fused1d analysis
    # runs unchanged.
    g12, o12 = 10000, 1000
    w12b = build_workload(40, g12, o12)
    ocoord12 = w12b[5][:, 0]
    corr12 = np.exp(-np.abs(ocoord12[:, None] - ocoord12[None, :]) / 15.0
                    ).astype("f4")
    corr12 += np.eye(o12, dtype="f4") * 0.1
    nb12 = exact_nb(max_in_support_1d(w12b[5][:, 0], w12b[4][:, 0], 20.0))
    letkf12 = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), inf_factor=1.1, method="fused1d",
        max_obs=nb12, cheb_degree=12,
    )
    w12 = (jnp.asarray(w12b[0]), jnp.asarray(w12b[1]),
           jnp.asarray(corr12), jnp.asarray(w12b[3]),
           jnp.asarray(w12b[4]), jnp.asarray(w12b[5]))

    @jax.jit
    def step12(acc, *w):
        return jnp.sum(letkf12(w[0] + acc * 1e-9, *w[1:])) * 1e-12

    progress("config 12: correlated R (Cholesky whitening)...")
    t12 = _chain_time(step12, w12, reps=50, r1=10, trials=3)
    emit({"metric": "letkf_correlated_r_grid_points_per_s",
          "value": round(g12 / t12, 1),
          "unit": "grid-points/s (full [1000,1000] correlated R, "
                  "Cholesky-whitened, ens=40, grid=10000, fused1d)"})


def main():
    import jax.numpy as jnp

    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.device import require_gpu, setup_compile_cache
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_1d

    setup_compile_cache()
    device = require_gpu()
    ens_size, len_grid, nr_obs, radius, inf = 40, 10000, 1000, 20.0, 1.1
    workload = build_workload(ens_size, len_grid, nr_obs)
    state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = workload

    def dist_fn(grid_coord, obs_info):
        # column 0 is the time column; distances on the spatial column
        return jnp.abs(obs_info[:, 1] - grid_coord[1])[None, :]

    loc = GaspariCohn((radius,), dist_fn)
    # The headline path: sorted-window selection (radius 20 -> cutoff 2r=40,
    # obs spacing 10 -> at most 9 nonzero-weight obs per column, so the
    # window is exact, not an approximation), Gaspari-Cohn taper,
    # neighbourhood gather and the Chebyshev/Clenshaw solve + weight
    # application (ops/window.py:letkf_window_analysis_fused).
    # cheb_degree=12 is validated for this workload's conditioning
    # (tests/test_accuracy_budget.py; the library default 16 covers harsher
    # conditioning).
    nb = exact_nb(max_in_support_1d(obs_coords[:, 0], grid_coords[:, 0],
                                    radius))
    analyse = make_letkf_analysis(
        loc, inf_factor=inf, chunksize=None,
        method="fused1d", max_obs=nb, cheb_degree=12,
    )
    args = tuple(
        jnp.asarray(a)
        for a in (state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords)
    )

    # Steady-state throughput: each rep feeds a data-dependent perturbation
    # of the state back into the next analysis (so XLA cannot hoist or fuse
    # across reps), all reps run inside ONE jitted fori_loop, and the fixed
    # per-invocation cost cancels in the two-point slope — see _chain_time.
    def chained(acc, *w):
        out = analyse(w[0] + acc * 1e-9, *w[1:])
        return jnp.sum(out) * 1e-12

    dev_time = _chain_time(chained, args, reps=200, r1=40, trials=4)
    dev_gps = len_grid / dev_time

    # numpy pytassim-style baseline on a grid subsample, extrapolated
    baseline_points = 2000
    t0 = time.perf_counter()
    _, n_done = numpy_reference_letkf(
        *workload, radius=radius, inf_factor=inf, max_points=baseline_points
    )
    base_time_per_point = (time.perf_counter() - t0) / n_done
    base_gps = 1.0 / base_time_per_point

    print(json.dumps({
        "metric": "letkf_analysis_grid_points_per_s",
        "value": round(dev_gps, 1),
        "unit": "grid-points/s (ens=40, grid=10000, obs=1000, GC r=20)",
        "vs_baseline": round(dev_gps / base_gps, 2),
        "device_time_ms": round(dev_time * 1e3, 4),
        "device": device,
    }))


if __name__ == "__main__":
    import sys

    if "--all" in sys.argv:
        run_all_configs()
    else:
        main()
