"""
Obs-sharded halo-exchange LETKF vs the replicated-obs path.

The device-mesh analog of the reference's dask chunked-vs-unchunked parity oracle
(/root/reference/tests/unit_tests/interface/test_letkf.py and
test_ienks.py:188-200, rtol=atol=1e-10): the halo-sharded analysis over an
8-device mesh must reproduce the single-program dense analysis exactly, for
any halo width that covers the taper support.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_assim.analysis import make_letkf_analysis
from tpu_assim.ops.localization import GaspariCohn
from tpu_assim.parallel.mesh import make_grid_mesh
from tpu_assim.parallel.halo import (
    halo_letkf_analysis,
    halo_width_for,
    shard_observations,
)

TOL = dict(rtol=1e-10, atol=1e-10)


def _dist_fn(grid_coord, obs_info):
    return jnp.abs(obs_info[:, 1] - grid_coord[1])[None, :]


def _workload(rng, ens_size=10, n_grid=128, n_obs=48):
    state = rng.normal(size=(ens_size, n_grid))
    obs_idx = np.sort(rng.choice(n_grid, size=n_obs, replace=False))
    obs_vals = rng.normal(size=n_obs)
    obs_var = rng.uniform(0.3, 1.5, size=n_obs)
    grid_coords = np.arange(n_grid, dtype=np.float64)[:, None]
    obs_coords = grid_coords[obs_idx]
    return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords


class TestHaloLETKF:
    @pytest.mark.parametrize("radius", [4.0, 7.0])
    def test_matches_dense_analysis(self, rng, radius):
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        n_grid = state.shape[1]
        loc = GaspariCohn((radius,), _dist_fn)

        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = dense(
            jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var),
            jnp.asarray(obs_idx), jnp.asarray(grid_coords),
            jnp.asarray(obs_coords),
        )

        mesh = make_grid_mesh(8)
        shard_span = n_grid / 8
        h = halo_width_for(radius, shard_span)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, n_grid, 8
        )
        analyse = halo_letkf_analysis(
            mesh, loc, max_obs=32, halo_width=h, inf_factor=1.1
        )
        result = analyse(
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        np.testing.assert_allclose(np.asarray(result), np.asarray(expected),
                                   **TOL)

    def test_2d_mesh_over_named_axis(self, rng):
        """A multi-axis mesh must shard over ``axis_name``'s extent only —
        the ring permutation used to be built from the *total* device count
        and indexed past the axis (latent wrong-answer bug)."""
        from jax.sharding import Mesh

        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        n_grid = state.shape[1]
        loc = GaspariCohn((4.0,), _dist_fn)

        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = dense(
            jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var),
            jnp.asarray(obs_idx), jnp.asarray(grid_coords),
            jnp.asarray(obs_coords),
        )

        devices = np.asarray(jax.devices()[:8]).reshape(4, 2)
        mesh = Mesh(devices, ("grid", "aux"))
        n_sh = 4  # the grid axis extent, NOT the 8 total devices
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, n_grid, n_sh
        )
        analyse = halo_letkf_analysis(
            mesh, loc, max_obs=32,
            halo_width=halo_width_for(4.0, n_grid / n_sh), inf_factor=1.1,
        )
        result = analyse(
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        np.testing.assert_allclose(np.asarray(result), np.asarray(expected),
                                   **TOL)

    @pytest.mark.parametrize("radius", [4.0, 7.0])
    def test_windowed_local_solve_matches_dense(self, rng, radius):
        """local_method='window' (per-shard monolithic window kernel over
        the sorted halo concat) must reproduce the dense analysis — same
        oracle as the top_k path, exercising the sorted ring order, the
        wrap sentinels, and the pad-slot pinning (unbalanced shard counts:
        the obs are randomly placed, so per-shard counts differ and real
        pad slots ride through the exchange)."""
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        n_grid = state.shape[1]
        loc = GaspariCohn((radius,), _dist_fn)

        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = dense(
            jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var),
            jnp.asarray(obs_idx), jnp.asarray(grid_coords),
            jnp.asarray(obs_coords),
        )

        mesh = make_grid_mesh(8)
        h = halo_width_for(radius, n_grid / 8)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, n_grid, 8
        )
        # cheb_degree 32: this workload's conditioning at radius 7 needs it
        # (degree 16 truncates at ~2e-4; 32 reaches the f32 floor ~2e-6 —
        # degree must track conditioning, see cheb_degree_for)
        analyse = halo_letkf_analysis(
            mesh, loc, max_obs=32, halo_width=h, inf_factor=1.1,
            local_method="window", cheb_degree=32,
        )
        result = analyse(
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        assert np.isfinite(np.asarray(result)).all()
        # the window path computes in f32 (like the single-chip fused
        # paths) — f32-floor tolerance vs the f64 dense oracle
        np.testing.assert_allclose(np.asarray(result), np.asarray(expected),
                                   rtol=5e-4, atol=5e-5)

    def test_windowed_rejects_multi_radius(self):
        loc = GaspariCohn((4.0, 5.0), _dist_fn)
        mesh = make_grid_mesh(8)
        with pytest.raises(ValueError, match="single localization"):
            halo_letkf_analysis(mesh, loc, max_obs=8, halo_width=1,
                                local_method="window")

    def test_unknown_axis_name_raises(self):
        loc = GaspariCohn((4.0,), _dist_fn)
        mesh = make_grid_mesh(8)
        with pytest.raises(ValueError, match="axis_name"):
            halo_letkf_analysis(mesh, loc, max_obs=8, halo_width=1,
                                axis_name="nope")

    def test_halo_width_bound(self):
        # cutoff 2r = 8, shard span 16 -> one neighbor is enough
        assert halo_width_for(4.0, 16.0) == 1
        # cutoff 40, shard span 16 -> three neighbors
        assert halo_width_for(20.0, 16.0) == 3

    def test_obs_bucketing_roundtrip(self, rng):
        _, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        vals, var, lidx, coords, valid, p = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, 128, 8
        )
        assert vals.shape == (8 * p,)
        # every real observation is present exactly once with its variance
        got = sorted(vals[valid > 0].tolist())
        assert np.allclose(got, sorted(obs_vals.tolist()))
        # local indices point inside the shard block
        assert (lidx >= 0).all() and (lidx < 128 // 8).all()

    def test_wider_halo_is_identical(self, rng):
        """Extra halo width must not change the result (wrapped candidates
        get taper weight exactly 0)."""
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        loc = GaspariCohn((4.0,), _dist_fn)
        mesh = make_grid_mesh(8)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, 128, 8
        )
        args = (
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        a1 = halo_letkf_analysis(mesh, loc, max_obs=32, halo_width=1,
                                 inf_factor=1.1)(*args)
        a2 = halo_letkf_analysis(mesh, loc, max_obs=32, halo_width=2,
                                 inf_factor=1.1)(*args)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), **TOL)


class TestHaloAutoDegree:
    """Auto Chebyshev degree + host-side exactness prechecks on the halo
    builders: the multi-chip entry points must be as safe
    by default as the class API — degree truncation is the one error class
    NaN-poisoning cannot catch."""

    def _stacked_workload(self, rng, n_grid=64, n_base=10, stack=8):
        """Smoother-style workload: every observation repeated ``stack``
        times at the same coordinate (stacked obs times) with small obs
        variance — tr(S) grows by the stack factor, so the spectral bound
        (and the required degree) is far beyond the old pinned default of
        16 (measured: auto picks ~96, pinned 16 truncates at ~5e-3)."""
        state = rng.normal(size=(10, n_grid))
        base_idx = np.sort(rng.choice(n_grid, size=n_base, replace=False))
        obs_idx = np.repeat(base_idx, stack)
        obs_vals = rng.normal(size=n_base * stack)
        obs_var = np.full(n_base * stack, 0.3)
        grid_coords = np.arange(n_grid, dtype=np.float64)[:, None]
        obs_coords = grid_coords[obs_idx]
        return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords

    def test_auto_degree_matches_eigh_where_pinned_16_fails(self, rng):
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = (
            self._stacked_workload(rng)
        )
        n_grid = state.shape[1]
        radius = 6.0
        loc = GaspariCohn((radius,), _dist_fn)
        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = np.asarray(dense(
            jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var),
            jnp.asarray(obs_idx), jnp.asarray(grid_coords),
            jnp.asarray(obs_coords),
        ))
        mesh = make_grid_mesh(4)
        h = halo_width_for(radius, n_grid / 4)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, n_grid, 4
        )
        args = (
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        # default args: cheb_degree=None auto-measures the spectral bound
        auto = np.asarray(halo_letkf_analysis(
            mesh, loc, max_obs=96, halo_width=h, inf_factor=1.1,
            local_method="window",
        )(*args))
        scale = np.abs(expected).max()
        err_auto = np.abs(auto - expected).max() / scale
        assert err_auto < 1e-4
        # the old pinned default demonstrably would not have matched
        pinned = np.asarray(halo_letkf_analysis(
            mesh, loc, max_obs=96, halo_width=h, inf_factor=1.1,
            local_method="window", cheb_degree=16,
        )(*args))
        err_pinned = np.abs(pinned - expected).max() / scale
        assert err_pinned > 100 * err_auto
        assert err_pinned > 1e-3

    def test_precheck_raises_on_slot_exhaustion(self, rng):
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = (
            self._stacked_workload(rng)
        )
        n_grid = state.shape[1]
        loc = GaspariCohn((6.0,), _dist_fn)
        mesh = make_grid_mesh(4)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, n_grid, 4
        )
        analyse = halo_letkf_analysis(
            mesh, loc, max_obs=8, halo_width=2, inf_factor=1.1,
            local_method="window",
        )
        with pytest.raises(ValueError, match="in-support"):
            analyse(
                jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
                jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
                jnp.asarray(grid_coords),
            )

    def test_auto_degree_requires_concrete_inputs(self, rng):
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        loc = GaspariCohn((4.0,), _dist_fn)
        mesh = make_grid_mesh(8)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, 128, 8
        )
        analyse = halo_letkf_analysis(
            mesh, loc, max_obs=32, halo_width=1, inf_factor=1.1,
            local_method="window",
        )

        @jax.jit
        def step(*a):
            return analyse(*a)

        with pytest.raises(ValueError, match="cheb_degree"):
            step(
                jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
                jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
                jnp.asarray(grid_coords),
            )

    def test_auto_degree_matches_pinned_equivalent(self, rng):
        """On the benign workload the auto path must agree with a pinned
        degree >= the measured one (same kernel, same math)."""
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = _workload(
            rng
        )
        loc = GaspariCohn((4.0,), _dist_fn)
        mesh = make_grid_mesh(8)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, obs_var, obs_idx, obs_coords, 128, 8
        )
        args = (
            jnp.asarray(state), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        auto = halo_letkf_analysis(
            mesh, loc, max_obs=32, halo_width=1, inf_factor=1.1,
            local_method="window",
        )(*args)
        pinned = halo_letkf_analysis(
            mesh, loc, max_obs=32, halo_width=1, inf_factor=1.1,
            local_method="window", cheb_degree=48,
        )(*args)
        np.testing.assert_allclose(np.asarray(auto), np.asarray(pinned),
                                   rtol=2e-5, atol=2e-6)


class TestHalo2D:
    """2-D domain decomposition: the (row, col)-tiled halo analysis must
    reproduce the dense single-program analysis exactly."""

    def _workload_2d(self, rng, ens=8, n_rows=16, n_cols=24, n_obs=60):
        state2d = rng.normal(size=(ens, n_rows, n_cols))
        flat_choices = rng.choice(n_rows * n_cols, size=n_obs, replace=False)
        obs_ij = np.stack(
            [flat_choices // n_cols, flat_choices % n_cols], axis=1
        ).astype(np.int32)
        obs_vals = rng.normal(size=n_obs)
        obs_var = rng.uniform(0.4, 1.2, size=n_obs)
        rr, cc = np.meshgrid(np.arange(n_rows, dtype=float),
                             np.arange(n_cols, dtype=float), indexing="ij")
        grid_coords = np.stack([rr, cc], axis=-1)           # [R, C, 2]
        obs_coords = grid_coords[obs_ij[:, 0], obs_ij[:, 1]]  # [o, 2]
        return state2d, obs_vals, obs_var, obs_ij, grid_coords, obs_coords

    @staticmethod
    def _dist2d(gc, oi):
        # per-dimension |dr|, |dc| distances (columns 1,2 of the info rows)
        return jnp.abs(oi[:, 1:3] - gc[1:3][None, :]).T

    def test_2d_matches_dense(self, rng):
        from jax.sharding import Mesh
        from tpu_assim.parallel.halo import (
            halo_letkf_analysis_2d, shard_observations_2d)

        ens, n_rows, n_cols = 8, 16, 24
        (state2d, obs_vals, obs_var, obs_ij, grid_coords,
         obs_coords) = self._workload_2d(rng, ens, n_rows, n_cols)
        radius = 3.0
        loc = GaspariCohn((radius,), self._dist2d)

        # dense reference on the flattened grid
        flat_idx = (obs_ij[:, 0] * n_cols + obs_ij[:, 1]).astype(np.int32)
        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = dense(
            jnp.asarray(state2d.reshape(ens, -1)), jnp.asarray(obs_vals),
            jnp.asarray(obs_var), jnp.asarray(flat_idx),
            jnp.asarray(grid_coords.reshape(-1, 2)), jnp.asarray(obs_coords),
        )

        mesh_shape = (2, 4)
        devices = np.asarray(jax.devices()[:8]).reshape(mesh_shape)
        mesh = Mesh(devices, ("row", "col"))
        vals, var, lidx, coords, valid, _ = shard_observations_2d(
            obs_vals, obs_var, obs_ij, obs_coords,
            (n_rows, n_cols), mesh_shape,
        )
        # tile spans: 8 rows, 6 cols; cutoff 2r=6 -> 1 tile halo each axis
        analyse = halo_letkf_analysis_2d(
            mesh, loc, max_obs=32, grid_shape=(n_rows, n_cols),
            halo=(1, 1), inf_factor=1.1,
        )
        result = analyse(
            jnp.asarray(state2d), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        np.testing.assert_allclose(
            np.asarray(result).reshape(ens, -1), np.asarray(expected), **TOL
        )

    def test_2d_windowed_local_solve_matches_dense(self, rng):
        """local_method='window' on the 2-D torus: per-tile monolithic
        fused2d kernel over the masked halo candidates (wrap/pad sentinels;
        the kernel re-sorts internally) must match the dense analysis at
        the f32 kernel floor."""
        from jax.sharding import Mesh
        from tpu_assim.parallel.halo import (
            halo_letkf_analysis_2d, shard_observations_2d)

        ens, n_rows, n_cols = 8, 16, 24
        (state2d, obs_vals, obs_var, obs_ij, grid_coords,
         obs_coords) = self._workload_2d(rng, ens, n_rows, n_cols)
        radius = 3.0
        loc = GaspariCohn((radius,), self._dist2d)

        flat_idx = (obs_ij[:, 0] * n_cols + obs_ij[:, 1]).astype(np.int32)
        dense = make_letkf_analysis(loc, inf_factor=1.1)
        expected = dense(
            jnp.asarray(state2d.reshape(ens, -1)), jnp.asarray(obs_vals),
            jnp.asarray(obs_var), jnp.asarray(flat_idx),
            jnp.asarray(grid_coords.reshape(-1, 2)), jnp.asarray(obs_coords),
        )

        mesh_shape = (2, 4)
        devices = np.asarray(jax.devices()[:8]).reshape(mesh_shape)
        mesh = Mesh(devices, ("row", "col"))
        vals, var, lidx, coords, valid, p = shard_observations_2d(
            obs_vals, obs_var, obs_ij, obs_coords,
            (n_rows, n_cols), mesh_shape,
        )
        # y-band block bound: all 9 neighborhood blocks (loose is fine —
        # too-small blocks NaN-poison, never truncate silently)
        blk = -(-9 * p // 8) * 8
        analyse = halo_letkf_analysis_2d(
            mesh, loc, max_obs=40, grid_shape=(n_rows, n_cols),
            halo=(1, 1), inf_factor=1.1, local_method="window",
            obs_block=blk, cheb_degree=32,
        )
        result = analyse(
            jnp.asarray(state2d), jnp.asarray(vals), jnp.asarray(var),
            jnp.asarray(lidx), jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(grid_coords),
        )
        out = np.asarray(result).reshape(ens, -1)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, np.asarray(expected),
                                   rtol=5e-4, atol=5e-5)

    def test_2d_windowed_requires_obs_block(self):
        from jax.sharding import Mesh
        from tpu_assim.parallel.halo import halo_letkf_analysis_2d

        loc = GaspariCohn((3.0,), self._dist2d)
        devices = np.asarray(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devices, ("row", "col"))
        with pytest.raises(ValueError, match="obs_block"):
            halo_letkf_analysis_2d(
                mesh, loc, max_obs=8, grid_shape=(16, 24),
                local_method="window",
            )

    def test_2d_obs_bucketing(self, rng):
        from tpu_assim.parallel.halo import shard_observations_2d

        (_, obs_vals, obs_var, obs_ij, _, obs_coords) = self._workload_2d(rng)
        vals, var, lidx, coords, valid, p = shard_observations_2d(
            obs_vals, obs_var, obs_ij, obs_coords, (16, 24), (2, 4))
        assert vals.shape == (8 * p,)
        got = sorted(vals[valid > 0].tolist())
        assert np.allclose(got, sorted(obs_vals.tolist()))
        assert (lidx >= 0).all() and (lidx < 8 * 6).all()


class TestHaloCorrelatedR:
    """Block-diagonal correlated R through the obs-sharded halo path:
    per-shard Cholesky whitening equals the single-device correlated
    analysis (the halo analog of the reference's mul_rcinv contract)."""

    def test_blockdiag_correlated_matches_dense(self, rng):
        import jax
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.parallel.halo import (
            halo_letkf_analysis, halo_width_for, shard_observations)
        from tpu_assim.parallel.mesh import make_grid_mesh

        n_dev = len(jax.devices())
        ens, g, o, radius = 10, 64 * n_dev, 8 * n_dev, 6.0
        state = rng.normal(size=(ens, g))
        shard_size = g // n_dev
        # obs clustered inside shards so correlations stay block-diagonal
        obs_idx = np.concatenate([
            np.sort(rng.choice(shard_size - 1, size=8, replace=False))
            + s * shard_size for s in range(n_dev)])
        obs_vals = rng.normal(size=o)
        cov = np.eye(o)
        for s in range(n_dev):  # correlate obs within each shard
            a = rng.randn(8, 8) * 0.2
            cov[s * 8:(s + 1) * 8, s * 8:(s + 1) * 8] += a @ a.T
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((radius,), dist)
        dense = make_letkf_analysis(loc, 1.1, method="eigh")(
            *map(jnp.asarray, (state, obs_vals, cov, obs_idx.astype("i4"),
                               grid_coords, obs_coords)))

        mesh = make_grid_mesh(n_dev)
        vals, var, lidx, coords, valid, _ = shard_observations(
            obs_vals, cov, obs_idx, obs_coords, g, n_dev)
        assert var.ndim == 2  # per-shard covariance blocks
        halo = halo_letkf_analysis(
            mesh, loc, max_obs=16,
            halo_width=halo_width_for(radius, g / n_dev), inf_factor=1.1)
        out = halo(*map(jnp.asarray,
                        (state, vals, var, lidx, coords, valid,
                         grid_coords)))
        np.testing.assert_allclose(np.asarray(out), np.asarray(dense),
                                   rtol=1e-9, atol=1e-9)

    def test_cross_shard_correlation_rejected(self, rng):
        from tpu_assim.parallel.halo import shard_observations

        o, g, n_dev = 8, 32, 4
        obs_idx = np.arange(0, 32, 4)
        cov = np.eye(o)
        cov[0, -1] = cov[-1, 0] = 0.5  # obs in shard 0 and shard 3
        with pytest.raises(ValueError, match="block-diagonal"):
            shard_observations(rng.normal(size=o), cov, obs_idx,
                               np.arange(o, dtype="f8")[:, None], g, n_dev)


class TestDistFnProbe:
    """The window-path dist_fn warning fires only for distances that do
    NOT behave as plain per-dimension |obs - grid| (the
    old always-on warning was pure noise, dist_func being a required
    constructor argument)."""

    def test_plain_lambda_passes(self):
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.parallel.halo import _plain_abs_dist_probe

        def dist1(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        assert _plain_abs_dist_probe(GaspariCohn((4.0,), dist1), 1)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        assert _plain_abs_dist_probe(GaspariCohn((4.0, 3.0), dist2), 2)

    def test_periodic_fails(self):
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.parallel.halo import _plain_abs_dist_probe

        def per(gc, oi):
            d = jnp.abs(oi[:, 1] - gc[1])
            return jnp.minimum(d, 40.0 - d)[None, :]

        assert not _plain_abs_dist_probe(GaspariCohn((4.0,), per), 1)

    def test_scaled_fails(self):
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.parallel.halo import _plain_abs_dist_probe

        def scaled(gc, oi):
            return (2.0 * jnp.abs(oi[:, 1] - gc[1]))[None, :]

        assert not _plain_abs_dist_probe(GaspariCohn((4.0,), scaled), 1)

    def test_window_build_is_quiet_for_plain_dist(self, caplog):
        import logging

        import jax
        from jax.sharding import Mesh
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.parallel.halo import halo_letkf_analysis

        def dist1(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        mesh = Mesh(np.array(jax.devices()), ("grid",))
        with caplog.at_level(logging.WARNING, logger="tpu_assim.parallel.halo"):
            halo_letkf_analysis(mesh, GaspariCohn((4.0,), dist1),
                                max_obs=8, halo_width=1,
                                local_method="window")
        assert not any("dist_fn" in r.message for r in caplog.records)
