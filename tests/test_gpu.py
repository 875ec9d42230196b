"""Compiled-on-the-GPU checks, marked ``gpu``: they skip without a card
and run on it through ``chip_smoke.py`` (``pytest -m gpu``).

The accuracy budget of every fused path, compiled for the GPU, against the
float64 oracle; and, each against the same program on the CPU, the headline
window analysis, its gradient (the GPU kernel's forward under the plain
twin's reverse rule) and the obs-sharded halo analysis with the window
solve."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

pytestmark = pytest.mark.gpu


def test_accuracy_budget_compiled(gpu):
    from scripts.accuracy_sweep import main as sweep_main

    rows = sweep_main(n_sample=256, full=False)
    assert rows
    bad = {r["config"]: r["max_rel_err"] for r in rows
           if not r["max_rel_err"] < 1e-5}
    assert not bad, bad


@pytest.mark.parametrize("method", ["fused1d", "cheb"])
def test_window_paths_gpu_match_cpu(gpu, method):
    import jax
    import jax.numpy as jnp

    from bench import build_workload, exact_nb
    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_1d

    w = build_workload(40, 10000, 1000)
    nb = exact_nb(max_in_support_1d(w[5][:, 0], w[4][:, 0], 20.0))
    loc = GaspariCohn((20.0,), lambda gc, oi: jnp.abs(oi[:, 1] - gc[1])[None])
    kw = dict(max_obs=nb, cheb_degree=12, method=method)
    if method == "cheb":
        kw["selection"] = "window"
    analyse = make_letkf_analysis(loc, 1.1, **kw)
    on_gpu = np.asarray(analyse(*(jax.device_put(a, gpu) for a in w)))
    cpu = jax.devices("cpu")[0]
    on_cpu = np.asarray(analyse(*(jax.device_put(a, cpu) for a in w)))
    err = np.abs(on_gpu - on_cpu).max() / np.abs(on_cpu).max()
    assert err < 1e-5, err


def _headline(g=10000, o=1000):
    import jax.numpy as jnp

    from bench import build_workload, exact_nb
    from tpu_assim.analysis import make_letkf_analysis
    from tpu_assim.ops.localization import GaspariCohn
    from tpu_assim.ops.window import max_in_support_1d

    w = build_workload(40, g, o)
    nb = exact_nb(max_in_support_1d(w[5][:, 0], w[4][:, 0], 20.0))
    loc = GaspariCohn((20.0,), lambda gc, oi: jnp.abs(oi[:, 1] - gc[1])[None])
    return w, nb, loc, make_letkf_analysis(loc, 1.1, method="fused1d",
                                           max_obs=nb, cheb_degree=12)


def test_fused1d_gradient_gpu_matches_cpu(gpu):
    """jax.grad through method="fused1d" in the state and the obs values:
    on the GPU the forward is the compiled kernel and the reverse pass the
    plain twin's; on the CPU both are the plain twin."""
    import jax
    import jax.numpy as jnp

    w, _, _, analyse = _headline()
    cot = np.random.RandomState(0).randn(*w[0].shape).astype("f4")

    def grads(device):
        rest = [jax.device_put(a, device) for a in w[2:]]
        ct = jax.device_put(cot, device)

        def loss(state, vals):
            return jnp.sum(analyse(state, vals, *rest) * ct)

        return jax.grad(loss, (0, 1))(jax.device_put(w[0], device),
                                      jax.device_put(w[1], device))

    on_gpu = grads(gpu)
    on_cpu = grads(jax.devices("cpu")[0])
    for a, b in zip(on_gpu, on_cpu):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.isfinite(a).all()
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-5, err


def test_halo_window_gpu_matches_cpu(gpu):
    """halo_letkf_analysis (ppermute ring, local_method="window") on a
    one-GPU mesh against the same program on a one-CPU mesh."""
    import jax

    from tpu_assim.parallel.halo import (
        halo_letkf_analysis, halo_width_for, shard_observations)
    from tpu_assim.parallel.mesh import make_grid_mesh

    w, nb, loc, _ = _headline()
    g = w[0].shape[1]
    vals, var, lidx, coords, valid, _ = shard_observations(
        w[1], w[2], w[3], w[5], g, 1)

    def run(device):
        analyse = halo_letkf_analysis(
            make_grid_mesh(devices=[device]), loc, max_obs=nb,
            halo_width=halo_width_for(20.0, g), inf_factor=1.1,
            local_method="window", cheb_degree=12)
        args = (w[0], vals, var, lidx, coords, valid, w[4])
        return np.asarray(analyse(*(jax.device_put(a, device)
                                    for a in args)))

    on_gpu = run(gpu)
    on_cpu = run(jax.devices("cpu")[0])
    assert np.isfinite(on_gpu).all()
    err = np.abs(on_gpu - on_cpu).max() / np.abs(on_cpu).max()
    assert err < 1e-5, err
