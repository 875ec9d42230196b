#!/usr/bin/env python
"""
Smoke run of the LETKF main path, compiled on one NVIDIA GPU at real sizes.

    python chip_smoke.py          # every single-card phase (one GPU)
    python chip_smoke.py --four   # only the multi-device path, on 4 GPUs

Run it from the repository root. Every phase compiles its program (compile
seconds printed), runs it to ``block_until_ready``, checks that the output
is finite, prints ``compiled.memory_analysis()`` and ``peak_bytes_in_use``,
and compares with a float64 oracle: the per-column eigh analysis of
``bench.py`` (the reference's execution model) on >= 2000 columns, or, for
the IEnKS and multi-device phases, the same program in float64 on the CPU /
on one card. One line of JSON per phase; the last line of standard output is
``{"ok": true, "device": {...}}`` and only appears when every phase passed.
Without a GPU the script exits non-zero before any phase runs.

The card's name and power limit come from ``nvidia-smi`` in a child process
that never imports JAX, so exactly one process holds the card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# the default backend is the GPU; the CPU backend stays available for the
# float64 reference runs
os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")

TOL = 1e-5          # docs/solvers.md "Accuracy budget"
N_COLS = 2000       # oracle columns per phase
RADIUS, INF = 20.0, 1.1


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, read without JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        return out or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def rel_err(out, ref) -> float:
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def dist_1d(gc, oi):
    import jax.numpy as jnp

    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def dist_2d(gc, oi):
    import jax.numpy as jnp

    return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                      jnp.abs(oi[:, 2] - gc[2])], 0)


class Report:
    """Collects phase results; a phase that raises is recorded as failed."""

    def __init__(self):
        self.ok = True

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            row = fn()
        except Exception as exc:  # recorded, and the script exits 1
            import traceback

            traceback.print_exc(file=sys.stdout)
            row = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        row = {"phase": name, **row,
               "wall_s": round(time.perf_counter() - t0, 3)}
        self.ok = self.ok and bool(row.get("ok"))
        log(json.dumps(row, default=float))
        return row


def peak_bytes(device=None) -> int:
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def memory_of(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {key: int(getattr(m, key)) for key in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, key)}


def compile_and_time(fn, args, reps=3):
    """Compile ``fn`` for ``args``, run it ``reps`` times. Returns
    (output, row) with compile seconds, median step ms, memory."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    row = {"compile_s": round(compile_s, 3),
           "step_ms": round(1e3 * float(np.median(times)), 4),
           "memory": memory_of(compiled), "peak_bytes_in_use": peak_bytes()}
    return out, row


def checked(row, out, err, tol=TOL):
    finite = bool(np.isfinite(np.asarray(out)).all())
    row.update(finite=finite, max_rel_err=err, tol=tol,
               ok=finite and err <= tol)
    return row


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------


def headline_setup(ens=40, g=10000, o=1000):
    from bench import build_workload, exact_nb
    from tpu_assim.ops.window import max_in_support_1d

    w = build_workload(ens, g, o)
    nb = exact_nb(max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS))
    return w, nb


def phase_headline(w, nb, ref):
    """README quick start: make_letkf_analysis(method="fused1d")."""
    import jax.numpy as jnp

    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn

    analyse = make_letkf_analysis(GaspariCohn((RADIUS,), dist_1d), INF,
                                  method="fused1d", max_obs=nb,
                                  cheb_degree=12)
    args = tuple(jnp.asarray(a) for a in w)
    analyse(*args)  # host-side exactness checks on concrete coordinates
    out, row = compile_and_time(analyse, args, reps=10)
    row["nb"] = nb
    return checked(row, out, rel_err(np.asarray(out)[:, :ref.shape[1]], ref))


def deployment_setup(ens=100, g=1 << 20, o=1 << 16, seed=0):
    """The deployment-sized cell: a 4-point-mean observation operator."""
    from bench import build_workload, exact_nb
    from tpu_assim.ops.window import max_in_support_1d

    w = build_workload(ens, g, o)
    stencil = np.stack([(w[3] + s) % g for s in range(4)],
                       axis=1).astype(np.int32)
    nb = exact_nb(max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS))
    cols = np.sort(np.random.RandomState(seed).choice(g, min(N_COLS, g),
                                                      replace=False))
    return w, stencil, nb, cols


def deployment_oracle(w, stencil, cols):
    from bench import gc_weights_numpy, oracle_columns

    state = np.asarray(w[0], np.float64)
    ens_obs = state[:, stencil].mean(axis=-1)
    mean_o = ens_obs.mean(axis=0)
    rcinv = 1.0 / np.sqrt(np.asarray(w[2], np.float64))
    perts = (ens_obs - mean_o) * rcinv
    innov = (np.asarray(w[1], np.float64) - mean_o) * rcinv
    gx, ox = w[4][:, 0].astype(np.float64), w[5][:, 0].astype(np.float64)
    return oracle_columns(
        state, perts, innov,
        lambda c: gc_weights_numpy(np.abs(gx[c] - ox), RADIUS), cols, INF)


def phase_deployment(w, stencil, nb, cols, ref):
    import jax.numpy as jnp

    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn

    def h(state_data):
        return jnp.mean(jnp.take(state_data, stencil, axis=-1), axis=-1)

    analyse = make_letkf_analysis(GaspariCohn((RADIUS,), dist_1d), INF,
                                  method="fused1d", max_obs=nb,
                                  obs_operator=h)
    args = tuple(jnp.asarray(a) for a in w)
    out, row = compile_and_time(analyse, args)
    row["nb"] = nb
    return checked(row, out, rel_err(np.asarray(out)[:, cols], ref))


def phase_class_api(w, ref, method, nb):
    """LETKF(...).assimilate(EnsembleState, Observation)."""
    import jax
    import jax.numpy as jnp

    from tpu_assim import LETKF, EnsembleState, Observation
    from tpu_assim.ops.localization import GaspariCohn

    state_np, obs_vals, obs_var, obs_idx, grid, obs_xy = w
    state = EnsembleState(jnp.asarray(state_np[None, None]),
                          times=jnp.zeros(1, jnp.float32),
                          grid_coords=jnp.asarray(grid))

    def operator(obs, pseudo_state):
        return pseudo_state.data[0][:, :, obs_idx]

    obs = Observation(jnp.asarray(obs_vals[None]),
                      covariance=jnp.asarray(obs_var),
                      obs_coords=jnp.asarray(obs_xy), times=state.times,
                      operator=operator)
    opts = dict(max_obs=nb, cheb_degree=12) if method == "fused1d" else {}
    letkf = LETKF(localization=GaspariCohn((RADIUS,), dist_1d),
                  inf_factor=INF, method=method, chunksize=None, **opts)
    t0 = time.perf_counter()
    out = jax.block_until_ready(letkf.assimilate(state, obs).data)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(letkf.assimilate(state, obs).data)
        times.append(time.perf_counter() - t0)
    # assimilate() is host-orchestrated (validation, obs-space set-up, then
    # jitted solves): the first call's time includes every compilation
    row = {"compile_s": round(first_s - float(np.median(times)), 3),
           "step_ms": round(1e3 * float(np.median(times)), 4),
           "memory": "n/a (several jitted programs)",
           "peak_bytes_in_use": peak_bytes()}
    out = np.asarray(out)[0, 0]
    return checked(row, out, rel_err(out[:, :ref.shape[1]], ref))


def l96_rk4_numpy(x, dt, n_steps, forcing=8.0):
    def f(s):
        return ((np.roll(s, -1, -1) - np.roll(s, 2, -1)) * np.roll(s, 1, -1)
                - s + forcing)

    for _ in range(n_steps):
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def phase_cycle(w, nb, n_cycles=3):
    """make_cycle_step (4 RK4 steps + fused1d analysis), chained. Each
    cycle is compared with the f64 forecast + oracle of its own input."""
    import jax.numpy as jnp

    from bench import oracle_columns, gc_weights_numpy
    from tpu_assim.analysis import make_cycle_step
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.ops.localization import GaspariCohn

    state, obs_vals, obs_var, obs_idx, grid, obs_xy = w
    step = make_cycle_step(
        RK4Integrator(Lorenz96(), dt=0.05), 4,
        GaspariCohn((RADIUS,), dist_1d), inf_factor=INF,
        method="fused1d", max_obs=nb, cheb_degree=12,
        geometry=(obs_idx, grid, obs_xy),
    )
    args = (jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var))
    out, row = compile_and_time(step, args)
    gx, ox = grid[:, 0].astype(np.float64), obs_xy[:, 0].astype(np.float64)
    cols = np.arange(min(N_COLS, grid.shape[0]))
    errs = []
    x = args[0]
    for _ in range(n_cycles):
        x_in = np.asarray(x, np.float64)
        x = step(x, args[1], args[2])
        fc = l96_rk4_numpy(x_in, 0.05, 4)
        ens_obs = fc[:, obs_idx]
        mean_o = ens_obs.mean(axis=0)
        rcinv = 1.0 / np.sqrt(obs_var.astype(np.float64))
        ref = oracle_columns(
            fc, (ens_obs - mean_o) * rcinv,
            (obs_vals.astype(np.float64) - mean_o) * rcinv,
            lambda c: gc_weights_numpy(np.abs(gx[c] - ox), RADIUS), cols,
            INF)
        errs.append(rel_err(np.asarray(x)[:, cols], ref))
    row["per_cycle_rel_err"] = errs
    return checked(row, x, max(errs))


def phase_lienks(w, nb, reduced=(1000, 100)):
    """make_lienks_step (2 outer iterations, batched [g, 40, 40] LU
    inverses and eighs):
    timed at full size; compared at a reduced size with the same program
    in float64 on the CPU."""
    import jax
    import jax.numpy as jnp

    from bench import build_workload
    from tpu_assim.analysis import make_lienks_step
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.ops.localization import GaspariCohn

    step = make_lienks_step(
        GaspariCohn((RADIUS,), dist_1d), RK4Integrator(Lorenz96(), dt=0.05),
        4, n_outer=2, tau=1.0, max_obs=nb, selection="window",
    )
    _, row = compile_and_time(step, tuple(jnp.asarray(a) for a in w))
    g_r, o_r = reduced
    wr = build_workload(40, g_r, o_r)
    small = jax.block_until_ready(step(*(jnp.asarray(a) for a in wr)))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        ref = step(*(jax.device_put(np.asarray(a, np.float64)
                                    if np.asarray(a).dtype.kind == "f"
                                    else np.asarray(a), cpu) for a in wr))
        ref = np.asarray(ref)
    row["reduced_shape"] = {"grid": g_r, "obs": o_r}
    return checked(row, small, rel_err(small, ref))


def phase_dense_solvers(batch=10_000, ks=(40, 100)):
    """cuSOLVER batched eigh and SVD at the ensemble sizes of the cells:
    time per call (one timed call: the SVD takes seconds), and the value
    error against float64 numpy on 64 matrices (reported; the phase
    requires finite output — raw f32 factorisations of random matrices are
    no accuracy-budget quantity)."""
    import jax.numpy as jnp

    rows = {}
    ok = True
    rs = np.random.RandomState(3)
    for k in ks:
        z = rs.normal(size=(batch, k, k)).astype(np.float32)
        spd = np.einsum("bij,bkj->bik", z, z) / k + np.eye(k, dtype="f4")
        for name, fn, x in (("eigh", jnp.linalg.eigh, spd),
                            ("svd", jnp.linalg.svd, z)):
            xd = jnp.asarray(x)
            out, timing = compile_and_time(fn, (xd,), reps=1)
            if name == "eigh":
                ev = np.asarray(out[0][:64], np.float64)
                ref = np.linalg.eigvalsh(x[:64].astype(np.float64))
            else:
                ev = np.asarray(out[1][:64], np.float64)
                ref = np.linalg.svd(x[:64].astype(np.float64),
                                    compute_uv=False)
            err = rel_err(ev, ref)
            ok = ok and bool(np.isfinite(ev).all())
            rows[f"{name}_[{batch},{k},{k}]"] = {
                "compile_s": timing["compile_s"],
                "step_ms": timing["step_ms"], "value_rel_err": err}
    return {"ok": ok, "solvers": rows, "peak_bytes_in_use": peak_bytes()}


def fused2d_setup(n=128, o=1024, seed=42):
    rs = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(n, dtype="f4"), np.arange(n, dtype="f4"),
                         indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = np.sort(rs.choice(n * n, size=o, replace=False)).astype(np.int32)
    state = rs.normal(size=(40, n * n)).astype("f4")
    vals = rs.normal(size=o).astype("f4")
    return state, vals, np.ones(o, "f4"), cells, grid, grid[cells]


def oracle_2d(w, radius, cols):
    from bench import gc_weights_numpy, oracle_columns

    state, vals, var, cells, grid, obs_xy = w
    state = np.asarray(state, np.float64)
    ens_obs = state[:, cells]
    mean_o = ens_obs.mean(axis=0)
    rcinv = 1.0 / np.sqrt(var.astype(np.float64))
    g64, o64 = grid.astype(np.float64), obs_xy.astype(np.float64)

    def weights(c):
        return (gc_weights_numpy(np.abs(g64[c, 0] - o64[:, 0]), radius)
                * gc_weights_numpy(np.abs(g64[c, 1] - o64[:, 1]), radius))

    return oracle_columns(state, (ens_obs - mean_o) * rcinv,
                          (vals.astype(np.float64) - mean_o) * rcinv,
                          weights, cols, INF)


def phase_fused2d(n=128, o=1024, radius=4.0):
    """method="fused2d" at 128 x 128 with 1024 obs."""
    import jax.numpy as jnp

    from bench import exact_nb
    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_2d, required_obs_block_2d

    w = fused2d_setup(n, o)
    blk = required_obs_block_2d(w[5][:, 1], w[4][:, 1], radius)
    nb = exact_nb(max_in_support_2d(w[5], w[4], radius, radius))
    analyse = make_letkf_analysis(
        GaspariCohn((radius, radius), dist_2d), INF, method="fused2d",
        max_obs=nb, cheb_degree=12, obs_block=blk)
    args = tuple(jnp.asarray(a) for a in w)
    out, row = compile_and_time(analyse, args)
    cols = np.sort(np.random.RandomState(1).choice(
        n * n, min(N_COLS, n * n), replace=False))
    ref = oracle_2d(w, radius, cols)
    row["nb"] = nb
    return checked(row, out, rel_err(np.asarray(out)[:, cols], ref))


def phase_strip2d(n=1024, o=100_000, n_strips=16, radius=4.0):
    """make_strip_letkf_2d: 1024 x 1024 grid, 1e5 obs, x-strips."""
    import jax.numpy as jnp

    from tpu_assim.analysis import make_strip_letkf_2d
    from tpu_assim.ops.localization import GaspariCohn

    w = fused2d_setup(n, o)
    t0 = time.perf_counter()
    analyse = make_strip_letkf_2d(
        GaspariCohn((radius, radius), dist_2d), (w[3], w[4], w[5]),
        n_strips=n_strips, inf_factor=INF, cheb_degree=16)
    plan_s = time.perf_counter() - t0
    args = tuple(jnp.asarray(a) for a in w[:3])
    out, row = compile_and_time(analyse, args, reps=2)
    cols = np.sort(np.random.RandomState(2).choice(
        n * n, min(N_COLS, n * n), replace=False))
    ref = oracle_2d(w, radius, cols)
    row.update(plan_s=round(plan_s, 3),
               shape={"grid": [n, n], "obs": o, "n_strips": n_strips})
    return checked(row, out, rel_err(np.asarray(out)[:, cols], ref))


def phase_gpu_tests():
    """The tests marked ``gpu``, in this process."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/"])
    return {"ok": int(rc) == 0, "pytest_exit_code": int(rc)}


def single_card(report):
    from bench import numpy_reference_letkf

    w, nb = headline_setup()
    ref = numpy_reference_letkf(*w, radius=RADIUS, inf_factor=INF,
                                max_points=N_COLS)[0]
    report.run("headline_fused1d", lambda: phase_headline(w, nb, ref))
    report.run("class_api_eigh", lambda: phase_class_api(w, ref, "eigh",
                                                         nb))
    report.run("class_api_fused1d",
               lambda: phase_class_api(w, ref, "fused1d", nb))
    report.run("cycle_fused1d", lambda: phase_cycle(w, nb))
    report.run("lienks", lambda: phase_lienks(w, nb))
    report.run("cusolver_eigh_svd", phase_dense_solvers)
    dw, stencil, dnb, cols = deployment_setup()
    dref = deployment_oracle(dw, stencil, cols)
    report.run("deployment_fused1d",
               lambda: phase_deployment(dw, stencil, dnb, cols, dref))
    del dw
    report.run("fused2d_128x128", phase_fused2d)
    report.run("strip2d_1024x1024", phase_strip2d)
    report.run("gpu_tests", phase_gpu_tests)


# ---------------------------------------------------------------------------
# four-card phases (--four): each sharded program against the same program
# on one card
# ---------------------------------------------------------------------------


def _sharded_vs_single(name, build, args_for, n_dev, reps=1):
    """Compile and time ``build(devices)`` on ``n_dev`` devices and on the
    first device alone; compare the two outputs. ``bytes_in_use`` per
    device is read while the sharded inputs and output are live, before
    the single-card run."""
    import jax

    devs = jax.devices()
    args = args_for(devs[:n_dev])
    out_m, row = compile_and_time(build(devs[:n_dev]), args, reps)
    stats = [d.memory_stats() or {} for d in devs[:n_dev]]
    row["bytes_in_use_per_device"] = [
        int(st.get("bytes_in_use", -1)) for st in stats]
    row["peak_bytes_in_use_per_device"] = [
        int(st.get("peak_bytes_in_use", -1)) for st in stats]
    out_m = np.asarray(out_m)
    del args
    out_s, row_s = compile_and_time(build(devs[:1]), args_for(devs[:1]),
                                    reps)
    row.update(single_card_step_ms=row_s["step_ms"],
               single_card_compile_s=row_s["compile_s"])
    return checked(row, out_m, rel_err(out_m, out_s))


def _put(a, devs, spec):
    """``a`` on ``devs`` with the grid axis sharded as ``spec`` says."""
    import jax
    from jax.sharding import Mesh, NamedSharding

    mesh = Mesh(np.asarray(devs), ("d",))
    return jax.device_put(a, NamedSharding(mesh, spec))


def phase_four_halo_1d(n_dev=4, ens=100, cols_per_card=1 << 18,
                       obs_per_card=1 << 14):
    """halo_letkf_analysis, ppermute ring, local_method="window"."""
    import jax

    from bench import build_workload, exact_nb
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.parallel.halo import (
        _halo_max_in_support, halo_letkf_analysis, halo_width_for,
        shard_observations)
    from tpu_assim.parallel.mesh import make_grid_mesh

    g, o = n_dev * cols_per_card, n_dev * obs_per_card
    w = build_workload(ens, g, o)
    loc = GaspariCohn((RADIUS,), dist_1d)
    sharded = {}

    def inputs(n):
        if n not in sharded:
            vals, var, lidx, coords, valid, _ = shard_observations(
                w[1], w[2], w[3], w[5], g, n)
            nb = exact_nb(_halo_max_in_support(coords, valid, n, RADIUS,
                                               "gc2", 1e-5, 1))
            sharded[n] = ((w[0], vals, var, lidx, coords, valid, w[4]), nb)
        return sharded[n]

    def build(devs):
        args, nb = inputs(len(devs))
        fn = halo_letkf_analysis(
            make_grid_mesh(devices=devs), loc, max_obs=nb,
            halo_width=halo_width_for(RADIUS, g / len(devs)),
            inf_factor=INF, local_method="window", cheb_degree=12)
        return fn

    def args_for(devs):
        from jax.sharding import PartitionSpec as P

        specs = (P(None, "d"), P("d"), P("d"), P("d"), P("d", None), P("d"),
                 P("d", None))
        return tuple(_put(a, devs, spec)
                     for a, spec in zip(inputs(len(devs))[0], specs))

    jax.block_until_ready(build(jax.devices()[:n_dev])(
        *args_for(jax.devices()[:n_dev])))  # host prechecks, concrete
    row = _sharded_vs_single("halo_1d", build, args_for, n_dev)
    row["shape"] = {"ens": ens, "grid": g, "obs": o, "devices": n_dev}
    return row


def phase_four_halo_2d(n_dev=4, ens=100, side=1024, n_obs=1 << 16,
                       radius=4.0):
    """halo_letkf_analysis_2d on a 2 x 2 (row x col) mesh, window solve."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bench import exact_nb
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_2d, required_obs_block_2d
    from tpu_assim.parallel.halo import (
        halo_letkf_analysis_2d, shard_observations_2d)

    rs = np.random.RandomState(5)
    state = rs.normal(size=(ens, side, side)).astype("f4")
    flat = rs.choice(side * side, size=n_obs, replace=False)
    obs_ij = np.stack([flat // side, flat % side], 1).astype(np.int32)
    rr, cc = np.meshgrid(np.arange(side, dtype="f4"),
                         np.arange(side, dtype="f4"), indexing="ij")
    grid = np.stack([rr, cc], axis=-1)
    obs_xy = grid[obs_ij[:, 0], obs_ij[:, 1]]
    vals = rs.normal(size=n_obs).astype("f4")
    var = np.ones(n_obs, "f4")
    gflat = grid.reshape(-1, 2)
    blk = required_obs_block_2d(obs_xy[:, 1], gflat[:, 1], radius)
    nb = exact_nb(max_in_support_2d(obs_xy, gflat, radius, radius))
    loc = GaspariCohn((radius,), lambda gc, oi: jnp.abs(
        oi[:, 1:3] - gc[1:3][None, :]).T)

    def mesh_shape(n):
        return (2, n // 2) if n > 1 else (1, 1)

    def build(devs):
        shape = mesh_shape(len(devs))
        mesh = Mesh(np.asarray(devs).reshape(shape), ("row", "col"))
        # halo of one tile per side covers the taper support (2 r = 8
        # rows/cols) for every tile of 512 rows/cols
        # tiles of a shard's local grid see other y-bands than tiles of
        # the whole grid: twice the global in-support maximum covers both
        # (the strict precheck raises otherwise)
        return halo_letkf_analysis_2d(
            mesh, loc, max_obs=2 * nb, grid_shape=(side, side),
            halo=(1, 1), inf_factor=INF, local_method="window",
            obs_block=blk, cheb_degree=12)

    def args_for(devs):
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(devs).reshape(mesh_shape(len(devs))),
                    ("row", "col"))
        tiles = P(("row", "col"))
        out = shard_observations_2d(vals, var, obs_ij, obs_xy, (side, side),
                                    mesh_shape(len(devs)))
        specs = (P(None, "row", "col"), tiles, tiles, tiles,
                 P(("row", "col"), None), tiles, P("row", "col", None))
        return tuple(jax.device_put(a, NamedSharding(mesh, spec))
                     for a, spec in zip((state,) + tuple(out[:5]) + (grid,),
                                        specs))

    row = _sharded_vs_single("halo_2d", build, args_for, n_dev)
    row["shape"] = {"ens": ens, "grid": [side, side], "obs": n_obs,
                    "mesh": list(mesh_shape(n_dev))}
    return row


def phase_four_sharded_letkf(n_dev=4, ens=100, cols_per_card=1 << 16,
                             n_obs=256):
    """parallel.letkf.sharded_letkf_analysis (dense taper + eigh weights).

    2**16 columns per card, not 2**18: the program holds about 140 KB per
    column (the [g, k, k] weights and their chunks), so the one-card run
    of the whole grid it is compared with has to stay under ~40 GB."""
    import jax

    from bench import build_workload
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.parallel.letkf import sharded_letkf_analysis
    from tpu_assim.parallel.mesh import make_grid_mesh

    g = n_dev * cols_per_card
    w = build_workload(ens, g, n_obs)
    # obs spacing g / n_obs = 128: a radius of 320 puts ~10 obs in support
    loc = GaspariCohn((2.5 * g / n_obs,), dist_1d)
    ens_obs = w[0][:, w[3]]
    mean_o = ens_obs.mean(axis=0)
    perts = (ens_obs - mean_o) / np.sqrt(w[2])
    innov = (w[1] - mean_o) / np.sqrt(w[2])
    zeros = np.zeros((g, 1), "f4")
    grid_info = np.concatenate([zeros, w[4]], axis=1)
    obs_info = np.concatenate([np.zeros((n_obs, 1), "f4"), w[5]], axis=1)

    def build(devs):
        mesh = make_grid_mesh(devices=devs)

        def fn(state4, perts, innov, grid_info, obs_info):
            return sharded_letkf_analysis(
                mesh, loc, state4, perts, innov, grid_info, obs_info, INF,
                chunksize=4096)
        return fn

    def args_for(devs):
        from jax.sharding import PartitionSpec as P

        return (_put(w[0][None, None], devs, P(None, None, None, "d")),
                _put(perts, devs, P()), _put(innov[None], devs, P()),
                _put(grid_info, devs, P("d", None)), _put(obs_info, devs, P()))

    row = _sharded_vs_single("sharded_letkf", build, args_for, n_dev)
    row["shape"] = {"ens": ens, "grid": g, "obs": n_obs}
    return row


def phase_four_lienks(n_dev=4, ens=100, cols_per_card=1 << 14,
                      n_obs=1 << 12):
    """make_lienks_step with the state sharded over the grid (GSPMD).

    2**14 columns per card, not 2**18: the program holds about 240 KB per
    column (several [g, k, k] weight matrices), so the one-card run of the
    whole grid it is compared with has to stay well inside one card, and
    that reference (2**16 columns) already spends ~2.5 min compiling one
    reduce fusion. Each
    card's eigh batch (16384 matrices of 100 x 100) is past cuSOLVER's
    batch limit, so the chunked path of ``ops.linalg.eigh_psd`` runs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import build_workload, exact_nb
    from tpu_assim.analysis import make_lienks_step
    from tpu_assim.models import Lorenz96, RK4Integrator
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_1d
    from tpu_assim.parallel.mesh import make_grid_mesh

    g = n_dev * cols_per_card
    w = build_workload(ens, g, n_obs)
    nb = exact_nb(max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS))
    step = make_lienks_step(
        GaspariCohn((RADIUS,), dist_1d), RK4Integrator(Lorenz96(), dt=0.05),
        4, n_outer=2, tau=1.0, max_obs=nb, selection="window")

    def build(devs):
        return step

    def args_for(devs):
        mesh = make_grid_mesh(devices=devs)
        state = jax.device_put(w[0], NamedSharding(mesh, P(None, "grid")))
        rest = tuple(jax.device_put(a, NamedSharding(mesh, P()))
                     for a in w[1:])
        return (state,) + rest

    row = _sharded_vs_single("lienks", build, args_for, n_dev)
    row["shape"] = {"ens": ens, "grid": g, "obs": n_obs}
    return row


def four_card(report):
    report.run("four_lienks_sharded", phase_four_lienks)
    report.run("four_sharded_letkf", phase_four_sharded_letkf)
    report.run("four_halo_1d", phase_four_halo_1d)
    report.run("four_halo_2d_2x2", phase_four_halo_2d)


def main(argv):
    four = "--four" in argv
    log(f"card: {nvidia_smi()}")
    import jax

    from tpu_assim.device import require_gpu, setup_compile_cache

    info = require_gpu()
    log(f"compile cache: {setup_compile_cache()}")
    log(f"jax {jax.__version__}, devices: {info}")
    report = Report()
    if four:
        if info["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, have {info['count']}")
        four_card(report)
    else:
        single_card(report)
    if not report.ok:
        log("FAILED: at least one phase failed")
        return 1
    log(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
