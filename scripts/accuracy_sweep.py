#!/usr/bin/env python
"""
Measured accuracy budget of the f32 fused paths vs the float64 oracle:
every BASELINE-config fused analysis compared
against a numpy float64 re-enactment of the exact per-column eigh solve
(the reference's computation model, pytassim/interface/letkf.py:127-143 +
core/etkf.py:57-77, which runs in f64 by default — interface/base.py:73).

Prints one line per config: max relative error over a grid-column sample
(the oracle loop is O(g·o), so large grids are subsampled column-wise —
the fused analysis itself always runs FULL, so blocking/selection effects
are fully exercised; only the comparison is sampled).

The committed bounds live in tests/test_accuracy_budget.py and
docs/solvers.md (table). ``python scripts/accuracy_sweep.py --full`` runs
the production shapes (on the GPU); without ``--full`` the large configs
run at reduced extent.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402

from bench import (  # noqa: E402
    build_workload,
    exact_nb,
    gc_weights_numpy,
    oracle_columns,
)


def normalized(state, obs_vals, obs_var, obs_idx):
    ens_obs = state[:, obs_idx]
    mean_o = ens_obs.mean(axis=0)
    rcinv = 1.0 / np.sqrt(obs_var)
    return (ens_obs - mean_o) * rcinv, (obs_vals - mean_o) * rcinv


def rel_err(fused, oracle, cols):
    f = np.asarray(fused, dtype=np.float64)[:, cols]
    scale = np.abs(oracle).max()
    return float(np.abs(f - oracle).max() / scale)


def main(n_sample=512, seed=123, full=False):
    """``full=True`` runs the large configs at their production shapes;
    ``False`` at a reduced extent (the selection and blocking structure
    are identical, only the extent shrinks)."""
    import jax

    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import (
        cheb_degree_for,
        max_in_support_1d,
        max_in_support_2d,
        required_obs_block_2d,
    )

    rows = []
    rnd = np.random.RandomState(seed)

    def dist_fn(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    # ---- 1-D fused1d at the headline config (ens=40, g=1e4, o=1e3) -----
    w = build_workload(40, 10000, 1000, dtype="float64")
    state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = w
    nb = exact_nb(max_in_support_1d(obs_coords[:, 0], grid_coords[:, 0],
                                    20.0))
    perts, innov = normalized(state, obs_vals, obs_var, obs_idx)
    cols = np.sort(rnd.choice(10000, size=n_sample, replace=False))
    oracle = oracle_columns(
        state, perts, innov,
        lambda g: gc_weights_numpy(
            np.abs(grid_coords[g, 0] - obs_coords[:, 0]), 20.0),
        cols,
    )
    args32 = tuple(jnp.asarray(np.asarray(a, dtype="f4" if np.asarray(
        a).dtype.kind == "f" else None)) for a in w)
    for degree in (12, 16):
        fused = make_letkf_analysis(
            GaspariCohn((20.0,), dist_fn), 1.1, method="fused1d",
            max_obs=nb, cheb_degree=degree)(*args32)
        rows.append({"config": f"fused1d deg{degree} (headline)",
                     "max_rel_err": rel_err(fused, oracle, cols)})

    cheb = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), 1.1, method="cheb", max_obs=nb,
        cheb_degree=12, selection="window")(*args32)
    rows.append({"config": "cheb deg12 window (headline)",
                 "max_rel_err": rel_err(cheb, oracle, cols)})

    # ---- 2-D fused2d at the 128x128 config -----------------------------
    nr = nc = 128
    g7, o7 = nr * nc, 1024
    rnd7 = np.random.RandomState(42)
    yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                         np.arange(nc, dtype="f8"), indexing="ij")
    grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = rnd7.choice(g7, size=o7, replace=False).astype(np.int32)
    obs_xy = grid_xy[cells]
    state7 = rnd7.normal(size=(40, g7))
    vals7 = rnd7.normal(size=o7)
    var7 = np.ones(o7)
    perts7, innov7 = normalized(state7, vals7, var7, cells)
    cols7 = np.sort(rnd.choice(g7, size=n_sample, replace=False))
    oracle7 = oracle_columns(
        state7, perts7, innov7,
        lambda g: (gc_weights_numpy(
            np.abs(grid_xy[g, 0] - obs_xy[:, 0]), 4.0)
            * gc_weights_numpy(
                np.abs(grid_xy[g, 1] - obs_xy[:, 1]), 4.0)),
        cols7,
    )

    def dist2(gc, oi):
        return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                          jnp.abs(oi[:, 2] - gc[2])], 0)

    blk7 = required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], 4.0)
    nb7 = exact_nb(max_in_support_2d(obs_xy, grid_xy, 4.0, 4.0))
    a7 = (jnp.asarray(state7, jnp.float32), jnp.asarray(vals7, jnp.float32),
          jnp.asarray(var7, jnp.float32), jnp.asarray(cells),
          jnp.asarray(grid_xy, jnp.float32),
          jnp.asarray(obs_xy, jnp.float32))
    for degree in (12, 16):
        fused2 = make_letkf_analysis(
            GaspariCohn((4.0, 4.0), dist2), 1.1, method="fused2d",
            max_obs=nb7, cheb_degree=degree, obs_block=blk7)(*a7)
        rows.append({"config": f"fused2d deg{degree} (128x128)",
                     "max_rel_err": rel_err(fused2, oracle7, cols7)})

    # ---- 4-D smoother stack: 4 obs times, auto-degree regime -----------
    #
    n_t = 4
    oc_s = np.repeat(obs_coords, n_t, axis=0)        # sorted stays sorted
    oi_s = np.repeat(obs_idx, n_t)
    vals_s = rnd.normal(size=1000 * n_t)
    var_s = np.ones(1000 * n_t)
    nb_s = exact_nb(max_in_support_1d(oc_s[:, 0], grid_coords[:, 0], 20.0))
    perts_s, innov_s = normalized(state, vals_s, var_s, oi_s)
    cs = np.concatenate([[0.0], np.cumsum((perts_s ** 2).sum(0))])
    tr_max = float((cs[nb_s:] - cs[:-nb_s]).max())
    deg_s = cheb_degree_for(1.0 + tr_max / (39.0 / 1.1))
    oracle_s = oracle_columns(
        state, perts_s, innov_s,
        lambda g: gc_weights_numpy(
            np.abs(grid_coords[g, 0] - oc_s[:, 0]), 20.0),
        cols,
    )
    fused_s = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), 1.1, method="fused1d",
        max_obs=nb_s, cheb_degree=deg_s)(
        *(jnp.asarray(np.asarray(a, dtype="f4" if np.asarray(a).dtype.kind
                                 == "f" else None))
          for a in (state, vals_s, var_s, oi_s, grid_coords, oc_s)))
    rows.append({"config": "fused1d smoother 4x-stack (auto degree)",
                 "max_rel_err": rel_err(fused_s, oracle_s, cols),
                 "auto_cheb_degree": int(deg_s)})

    # ---- halo windowed local solve (bench config 3 shape) ---------------
    # (the pad-slot/wrapped-block arithmetic of parallel/halo.py)
    from tpu_assim.parallel.halo import (
        _halo_max_in_support,
        halo_letkf_analysis,
        halo_width_for,
        shard_observations,
    )
    from tpu_assim.parallel.mesh import make_grid_mesh

    n_dev = len(jax.devices())
    g3 = 10240
    w3 = build_workload(40, g3, 1024, dtype="float64")
    vals3, var3, lidx3, coords3, valid3, _ = shard_observations(
        w3[1], w3[2], w3[3], w3[5], g3, n_dev)
    nb3 = exact_nb(_halo_max_in_support(coords3, valid3, n_dev, 20.0,
                                        "gc2", 1e-5, 1))
    halo = halo_letkf_analysis(
        make_grid_mesh(n_dev), GaspariCohn((20.0,), dist_fn), max_obs=nb3,
        halo_width=halo_width_for(20.0, g3 / n_dev), inf_factor=1.1,
        local_method="window", cheb_degree=12,
    )
    h_args = tuple(
        jnp.asarray(np.asarray(a, dtype="f4")
                    if np.asarray(a).dtype.kind == "f" else np.asarray(a))
        for a in (w3[0], vals3, var3, lidx3, coords3, valid3, w3[4])
    )
    fused_h = halo(*h_args)
    perts3, innov3 = normalized(w3[0], w3[1], w3[2], w3[3])
    cols3 = np.sort(rnd.choice(g3, size=n_sample, replace=False))
    oracle3 = oracle_columns(
        w3[0], perts3, innov3,
        lambda g: gc_weights_numpy(
            np.abs(w3[4][g, 0] - w3[5][:, 0]), 20.0),
        cols3,
    )
    rows.append({"config": f"halo window ({n_dev} dev)",
                 "max_rel_err": rel_err(fused_h, oracle3, cols3)})

    # ---- strip-2D production path ---------------------------------------
    # (full: the bench config-8 1024x1024/1e5-obs shape; reduced: same
    # strip machinery at 256x256/6k obs — identical seam/overlap logic)
    from tpu_assim.analysis import make_strip_letkf_2d

    nrs = 1024 if full else 256
    o_s2 = 100_000 if full else 6000
    n_strips = 16 if full else 4
    rnd8 = np.random.RandomState(42)
    g_s2 = nrs * nrs
    yy8, xx8 = np.meshgrid(np.arange(nrs, dtype="f8"),
                           np.arange(nrs, dtype="f8"), indexing="ij")
    grid_xy8 = np.stack([xx8.ravel(), yy8.ravel()], 1)
    cells8 = np.sort(rnd8.choice(g_s2, size=o_s2, replace=False)
                     ).astype(np.int32)
    obs_xy8 = grid_xy8[cells8]
    state8 = rnd8.normal(size=(40, g_s2))
    vals8 = rnd8.normal(size=o_s2)
    var8 = np.ones(o_s2)

    def dist2(gc, oi):
        return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                          jnp.abs(oi[:, 2] - gc[2])], 0)

    strip = make_strip_letkf_2d(
        GaspariCohn((4.0, 4.0), dist2), (cells8, grid_xy8, obs_xy8),
        n_strips=n_strips, inf_factor=1.1, cheb_degree=16,
    )
    fused_strip = strip(jnp.asarray(state8, jnp.float32),
                        jnp.asarray(vals8, jnp.float32),
                        jnp.asarray(var8, jnp.float32))
    perts8, innov8 = normalized(state8, vals8, var8, cells8)
    cols8 = np.sort(rnd.choice(g_s2, size=n_sample, replace=False))
    oracle8 = oracle_columns(
        state8, perts8, innov8,
        lambda g: (gc_weights_numpy(
            np.abs(grid_xy8[g, 0] - obs_xy8[:, 0]), 4.0)
            * gc_weights_numpy(
                np.abs(grid_xy8[g, 1] - obs_xy8[:, 1]), 4.0)),
        cols8,
    )
    rows.append({"config": f"strip2d ({nrs}x{nrs}, {n_strips} strips)",
                 "max_rel_err": rel_err(fused_strip, oracle8, cols8)})

    # ---- large config: ens=100, 4-pt-mean batched obs operator ----------
    # (full: the bench config-5 2^20/2^16 shape; reduced: 2^16/2^12)
    g5 = 1 << 20 if full else 1 << 16
    o5 = 1 << 16 if full else 1 << 12
    w5 = build_workload(100, g5, o5, dtype="float64")
    idx5 = np.asarray(w5[3])
    stencil5 = np.stack([(idx5 + s) % g5 for s in range(4)],
                        axis=1).astype(np.int32)

    def h5(state_data):
        return jnp.mean(jnp.take(state_data, stencil5, axis=-1), axis=-1)

    nb5 = exact_nb(max_in_support_1d(w5[5][:, 0], w5[4][:, 0], 20.0))
    fused5 = make_letkf_analysis(
        GaspariCohn((20.0,), dist_fn), 1.1, method="fused1d",
        max_obs=nb5, obs_operator=h5)(
        jnp.asarray(w5[0], jnp.float32), jnp.asarray(w5[1], jnp.float32),
        jnp.asarray(w5[2], jnp.float32), jnp.asarray(w5[3]),
        jnp.asarray(w5[4], jnp.float32), jnp.asarray(w5[5], jnp.float32))
    ens_obs5 = w5[0][:, stencil5].mean(axis=-1)
    mean5 = ens_obs5.mean(axis=0)
    perts5 = ens_obs5 - mean5
    innov5 = w5[1] - mean5
    cols5 = np.sort(rnd.choice(g5, size=n_sample, replace=False))
    oracle5 = oracle_columns(
        w5[0], perts5, innov5,
        lambda g: gc_weights_numpy(
            np.abs(w5[4][g, 0] - w5[5][:, 0]), 20.0),
        cols5,
    )
    rows.append({"config": f"large ens100 (2^{g5.bit_length() - 1} cols, "
                           "4pt-mean H)",
                 "max_rel_err": rel_err(fused5, oracle5, cols5)})

    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main(full="--full" in sys.argv)
