"""Sharded-vs-single-device parity tests — the SPMD analog of the
reference's dask chunked-vs-unchunked oracle
(/root/reference/tests/unit_tests/interface/test_etkf.py:109,
test_ienks.py:188-200): the sharded SPMD program must reproduce the
single-device analysis to allclose 1e-10."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_assim.ops.etkf import letkf_weights_dense
from tpu_assim.ops.localization import GaspariCohn
from tpu_assim.parallel import (
    make_grid_mesh,
    make_forecast_analysis_mesh,
    shard_state,
    sharded_letkf_weights,
    sharded_letkf_analysis,
)
from tpu_assim.testing import dummy_distance
from tpu_assim.state import EnsembleState


@pytest.fixture
def mesh():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return make_grid_mesh(8)


@pytest.fixture
def problem(rng):
    k, l, g, d = 10, 24, 64, 2
    perts = jnp.asarray(rng.randn(k, l))
    innov = jnp.asarray(rng.randn(l))
    grid_info = jnp.asarray(
        np.hstack([np.zeros((g, 1)), np.arange(g)[:, None].astype(float)])
    )
    obs_info = jnp.asarray(
        np.hstack(
            [np.zeros((l, 1)), rng.uniform(0, g, size=(l, 1))]
        )
    )
    return perts, innov, grid_info, obs_info


def test_sharded_weights_match_local(mesh, problem):
    perts, innov, grid_info, obs_info = problem
    loc = GaspariCohn((8.0,), dummy_distance)
    w_loc = loc.taper_weights(grid_info, obs_info)
    expected = letkf_weights_dense(perts, innov, w_loc, 1.1)
    sharded = sharded_letkf_weights(
        mesh, loc, perts, innov, grid_info, obs_info, 1.1
    )
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(expected), atol=1e-10, rtol=1e-10
    )


def test_sharded_weights_no_localization(mesh, problem):
    perts, innov, grid_info, obs_info = problem
    w_loc = jnp.ones((grid_info.shape[0], innov.shape[0]))
    expected = letkf_weights_dense(perts, innov, w_loc, 1.0)
    sharded = sharded_letkf_weights(
        mesh, None, perts, innov, grid_info, obs_info, 1.0
    )
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(expected), atol=1e-10, rtol=1e-10
    )


def test_sharded_analysis_matches_local(mesh, problem, rng):
    perts, innov, grid_info, obs_info = problem
    g = grid_info.shape[0]
    loc = GaspariCohn((8.0,), dummy_distance)
    state_data = jnp.asarray(rng.randn(2, 1, 10, g))

    # local oracle
    w_loc = loc.taper_weights(grid_info, obs_info)
    weights = letkf_weights_dense(perts, innov, w_loc, 1.1)
    mean = jnp.mean(state_data, axis=2, keepdims=True)
    sp = state_data - mean
    expected = mean + jnp.einsum("vtkg,gkm->vtmg", sp, weights)

    analysis = sharded_letkf_analysis(
        mesh, loc, state_data, perts, innov, grid_info, obs_info, 1.1
    )
    np.testing.assert_allclose(
        np.asarray(analysis), np.asarray(expected), atol=1e-10, rtol=1e-10
    )


def test_sharded_analysis_with_chunking(mesh, problem, rng):
    perts, innov, grid_info, obs_info = problem
    g = grid_info.shape[0]
    loc = GaspariCohn((8.0,), dummy_distance)
    state_data = jnp.asarray(rng.randn(1, 1, 10, g))
    full = sharded_letkf_analysis(
        mesh, loc, state_data, perts, innov, grid_info, obs_info, 1.0,
        chunksize=None,
    )
    chunked = sharded_letkf_analysis(
        mesh, loc, state_data, perts, innov, grid_info, obs_info, 1.0,
        chunksize=3,
    )
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(chunked), atol=1e-10, rtol=1e-10
    )


def test_shard_state_roundtrip(mesh, rng):
    state = EnsembleState(
        jnp.asarray(rng.randn(1, 1, 4, 16)),
        grid_coords=jnp.arange(16.0)[:, None],
    )
    sharded = shard_state(state, mesh)
    np.testing.assert_allclose(
        np.asarray(sharded.data), np.asarray(state.data)
    )
    assert sharded.valid


def test_2d_mesh_construction():
    mesh = make_forecast_analysis_mesh(2, 4)
    assert mesh.shape == {"ens": 2, "grid": 4}


def test_lienks_step_auto_shards(mesh, rng):
    """The jitted localized-IEnKS smoother (analysis.make_lienks_step)
    is pure jnp, so it auto-partitions under pjit with a grid-sharded
    state — GSPMD inserts the L96 halo collectives for the forecast
    rolls and keeps the per-column solve local. Sharded == local to
    1e-10 (the iterative-smoother family's multi-chip path)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_assim.analysis import make_lienks_step
    from tpu_assim.models import Lorenz96, RK4Integrator

    g, k, n_int = 64, 10, 3
    integ = RK4Integrator(Lorenz96(), dt=0.05)
    state = jnp.asarray(rng.normal(size=(k, g)) + 2.0)
    obs_idx = jnp.arange(0, g, 2, dtype=jnp.int32)
    obs_vals = jnp.asarray(rng.normal(size=g // 2))
    obs_var = jnp.full((g // 2,), 0.5)
    grid_coords = jnp.arange(g, dtype=float)[:, None]
    obs_coords = grid_coords[obs_idx]
    loc = GaspariCohn((4.0,), dummy_distance)
    step = make_lienks_step(loc, integ, n_int, n_outer=2, tau=0.8,
                            max_obs=18, selection="window")
    local = step(state, obs_vals, obs_var, obs_idx, grid_coords,
                 obs_coords)

    sh = NamedSharding(mesh, P(None, "grid"))
    state_sh = jax.device_put(state, sh)
    out_sh = step(state_sh, obs_vals, obs_var, obs_idx, grid_coords,
                  obs_coords)
    np.testing.assert_allclose(np.asarray(out_sh), np.asarray(local),
                               atol=1e-10, rtol=1e-10)
