"""LKETKF dense vs fixed-size-neighborhood fast path.

Criterion: the max_obs path beats the dense taper path
>= 5x at g = 1e5. Prints one JSON line per configuration.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from tpu_assim.interface.lketkf import _lketkf_solve
from tpu_assim.ops.kernels import GaussKernel
from tpu_assim.ops.localization import GaspariCohn


def dist(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def timeit(fn, *args, reps=3):
    out = fn(*args)
    jax.tree.map(lambda y: y.block_until_ready(), out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.tree.map(lambda y: y.block_until_ready(), out)
    return (time.perf_counter() - t0) / reps


def main():
    rng = np.random.default_rng(0)
    k = 40
    for g, o, radius, nb in ((100_000, 2_000, 200.0, 24),):
        perts = jnp.asarray(rng.standard_normal((k, o)), jnp.float32)
        innov = jnp.asarray(rng.standard_normal(o), jnp.float32)
        grid_info = jnp.asarray(
            np.stack([np.zeros(g), np.arange(g, dtype="f8")], 1), jnp.float32
        )
        obs_x = np.sort(rng.uniform(0, g, size=o))
        obs_info = jnp.asarray(
            np.stack([np.zeros(o), obs_x], 1), jnp.float32
        )
        loc = GaspariCohn((radius,), dist)
        kern = GaussKernel(2.0)
        rho = jnp.float32(1.05)
        # warm-up + time: dense (chunked to bound the [c, k, o] tensor)
        t_dense = timeit(
            lambda: _lketkf_solve(loc, 4096, "eigh", 25, None, "topk",
                                  True, kern, perts, innov, grid_info,
                                  obs_info, rho))
        # fast: window neighborhoods (sorted obs), nb slots
        t_fast = timeit(
            lambda: _lketkf_solve(loc, 8192, "eigh", 25, nb, "window",
                                  False, kern, perts, innov, grid_info,
                                  obs_info, rho))
        print(json.dumps({
            "g": g, "o": o, "nb": nb,
            "dense_ms": round(t_dense * 1e3, 1),
            "fast_ms": round(t_fast * 1e3, 1),
            "speedup": round(t_dense / t_fast, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
