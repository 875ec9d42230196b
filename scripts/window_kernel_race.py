#!/usr/bin/env python
"""
Race the 1-D window GPU kernel against its plain XLA twin, in turns
(plain, kernel, kernel, plain), at the headline and deployment shapes.

    python scripts/window_kernel_race.py            # on the GPU
    python scripts/window_kernel_race.py --tiny     # CPU rehearsal

Both time the solve + apply stage of ``method="fused1d"`` on the same
inputs: the normalised obs-space perturbations and innovations, the state
perturbations and mean, and the window starts of the XLA prologue
(``ops.window._window_starts``). The kernel is
``ops.window_kernel.window_analysis_kernel``, the twin
``ops.window._window_plain``. Each turn reports the median step time over
``reps`` calls that end in ``block_until_ready``, and the relative
difference between the two outputs. One JSON line per shape.
"""

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RADIUS, INF, DEGREE = 20.0, 1.1, 12


def _median_ms(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def stage_inputs(ens, g, o, four_point):
    """The window stage's inputs for ``bench.build_workload``'s problem,
    with a point or a 4-point-mean observation operator."""
    import jax
    import jax.numpy as jnp

    from bench import build_workload, exact_nb
    from tpu_assim.ops import window

    state, vals, var, idx, grid, obs_xy = build_workload(ens, g, o)
    nb = exact_nb(window.max_in_support_1d(obs_xy[:, 0], grid[:, 0], RADIUS))
    stencil = (np.stack([(idx + s) % g for s in range(4)], axis=1)
               if four_point else idx[:, None])
    ens_obs = state[:, stencil].mean(axis=-1)
    rcinv = 1.0 / np.sqrt(var)
    mean = state.mean(axis=0)
    f32 = np.float32
    arrays = dict(
        perts=((ens_obs - ens_obs.mean(axis=0)) * rcinv).astype(f32),
        innov=((vals - ens_obs.mean(axis=0)) * rcinv).astype(f32),
        obs_x=obs_xy[:, 0].astype(f32), grid_x=grid[:, 0].astype(f32),
        sp=(state - mean)[None].astype(f32), mean=mean[None].astype(f32))
    arrays = {key: jnp.asarray(a) for key, a in arrays.items()}
    start, poison = jax.jit(functools.partial(
        window._window_starts, nb=nb, epsilon=1e-5, taper="gc2",
        strict=True))(arrays["obs_x"], arrays["grid_x"], f32(RADIUS))
    args = (arrays["perts"], arrays["innov"], arrays["obs_x"],
            arrays["grid_x"], start, poison, arrays["sp"], arrays["mean"],
            jnp.float32((ens - 1) / INF), jnp.float32(RADIUS))
    return args, nb


def race(ens, g, o, four_point, reps, interpret):
    import jax

    from tpu_assim.ops.window import _window_plain
    from tpu_assim.ops.window_kernel import window_analysis_kernel

    args, nb = stage_inputs(ens, g, o, four_point)
    opts = dict(ens_size=ens, nb=nb, degree=DEGREE, epsilon=1e-5,
                taper="gc2")
    fns = {}
    for route, fn in (
            ("plain", functools.partial(_window_plain, **opts)),
            ("kernel", functools.partial(window_analysis_kernel, **opts,
                                         interpret=interpret))):
        t0 = time.perf_counter()
        fns[route] = (jax.jit(fn).lower(*args).compile(),
                      time.perf_counter() - t0)
    out_p = np.asarray(fns["plain"][0](*args))
    out_k = np.asarray(fns["kernel"][0](*args))
    turns = [(route, _median_ms(fns[route][0], args, reps))
             for route in ("plain", "kernel", "kernel", "plain")]
    return {
        "shape": {"ens": ens, "grid": g, "obs": o, "nb": nb,
                  "obs_operator": "4-point mean" if four_point else "point"},
        "turns_ms": turns,
        "plain_ms": float(np.mean([t for r, t in turns if r == "plain"])),
        "kernel_ms": float(np.mean([t for r, t in turns if r == "kernel"])),
        "compile_s": {r: round(fns[r][1], 3) for r in fns},
        "kernel_vs_plain_rel": float(np.abs(out_k - out_p).max()
                                     / np.abs(out_p).max()),
        "finite": bool(np.isfinite(out_k).all()),
        "device": jax.devices()[0].device_kind,
    }


def main(argv):
    tiny = "--tiny" in argv
    if tiny:
        shapes = [(8, 300, 40, False), (10, 1024, 64, True)]
        reps = 2
    else:
        from tpu_assim.device import require_gpu, setup_compile_cache

        setup_compile_cache()
        require_gpu()
        shapes = [(40, 10_000, 1_000, False), (100, 1 << 20, 1 << 16, True)]
        reps = 10
    rows = [race(*s, reps=reps, interpret=tiny) for s in shapes]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
