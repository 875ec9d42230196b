"""
Localization unit tests (reference intent:
tests/unit_tests/localization/test_gaspari_cohn.py) + profiling utilities.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_assim.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    abs_distance,
    neighborhood_select,
    periodic_distance,
)


def _dist1d(gc, oi):
    return jnp.abs(oi[:, 0] - gc[0])[None, :]


class TestGaspariCohn:
    def test_known_values(self):
        """GC(z, 1/2, c) hand values: 1 at z=0, 0 beyond z=2, inner/outer
        segment values from the reference polynomials
        (gaspari_cohn.py:77-95)."""
        loc = GaspariCohn((1.0,), _dist1d)
        obs = jnp.asarray([[0.0], [0.5], [1.0], [1.5], [2.0], [3.0]])
        _, w = loc.localize_obs(jnp.asarray([0.0]), obs)
        w = np.asarray(w)
        np.testing.assert_allclose(w[0], 1.0, atol=1e-12)
        # z=0.5: -0.25/32 + 0.5/16 + 0.625/8 - 5/3/4 + 1
        np.testing.assert_allclose(
            w[1], -0.25 / 32 + 0.5 / 16 + 0.625 / 8 - 5 / 3 / 4 + 1.0,
            rtol=1e-12,
        )
        # z=1: both segments give 1/12 - 1/2 + 0.625 + 5/3 - 5 + 4 - 2/3
        np.testing.assert_allclose(
            w[2], 1 / 12 - 0.5 + 0.625 + 5 / 3 - 5 + 4 - 2 / 3, rtol=1e-9
        )
        np.testing.assert_allclose(w[4], 0.0, atol=1e-10)
        np.testing.assert_allclose(w[5], 0.0, atol=1e-12)

    def test_continuity_at_segment_boundary(self):
        loc = GaspariCohn((1.0,), _dist1d)
        obs = jnp.asarray([[1.0 - 1e-9], [1.0 + 1e-9]])
        _, w = loc.localize_obs(jnp.asarray([0.0]), obs)
        np.testing.assert_allclose(float(w[0]), float(w[1]), atol=1e-6)

    def test_multidim_radii_multiply(self, rng):
        def dist2d(gc, oi):
            return jnp.abs(oi - gc[None, :]).T  # [2, o]

        loc = GaspariCohn((2.0, 5.0), dist2d)
        obs = jnp.asarray(rng.uniform(0, 3, size=(20, 2)))
        grid = jnp.asarray([1.0, 1.0])
        _, w = loc.localize_obs(grid, obs)
        loc_a = GaspariCohn((2.0,), _dist1d)
        loc_b = GaspariCohn((5.0,), _dist1d)
        _, wa = loc_a.localize_obs(grid[:1], obs[:, :1])
        _, wb = loc_b.localize_obs(grid[1:], obs[:, 1:])
        np.testing.assert_allclose(np.asarray(w),
                                   np.asarray(wa) * np.asarray(wb),
                                   rtol=1e-10)

    def test_taper_weights_matches_localize_obs(self, rng):
        loc = GaspariCohn((3.0,), _dist1d)
        grid = jnp.asarray(rng.uniform(0, 50, size=(12, 1)))
        obs = jnp.asarray(rng.uniform(0, 50, size=(30, 1)))
        batched = np.asarray(loc.taper_weights(grid, obs))
        for i in range(12):
            use, w = loc.localize_obs(grid[i], obs)
            np.testing.assert_allclose(
                batched[i], np.where(np.asarray(use), np.asarray(w), 0.0),
                rtol=1e-12,
            )


class TestGaspariCohnInf:
    def test_value_range_and_support(self, rng):
        loc = GaspariCohnInf(1.0, _dist1d)
        obs = jnp.asarray(rng.uniform(0, 3, size=(50, 1)))
        _, w = loc.localize_obs(jnp.asarray([0.0]), obs)
        w = np.asarray(w)
        d = np.abs(np.asarray(obs[:, 0]))
        assert (w[d >= 2.0] == 0).all()
        assert (w <= 1.0 + 1e-9).all()

    def test_one_at_zero(self):
        loc = GaspariCohnInf(1.0, _dist1d)
        _, w = loc.localize_obs(jnp.asarray([5.0]), jnp.asarray([[5.0]]))
        np.testing.assert_allclose(float(w[0]), 1.0, atol=1e-12)

    def test_wider_support_than_gc_half(self, rng):
        """GC-inf decays slower than GC-1/2 at mid range."""
        g = GaspariCohn((1.0,), _dist1d)
        gi = GaspariCohnInf(1.0, _dist1d)
        obs = jnp.asarray([[1.0]])
        _, w_half = g.localize_obs(jnp.asarray([0.0]), obs)
        _, w_inf = gi.localize_obs(jnp.asarray([0.0]), obs)
        assert float(w_inf[0]) > float(w_half[0])


class TestDistances:
    def test_abs_distance(self):
        d = abs_distance(jnp.asarray([1.0]), jnp.asarray([[0.0], [3.0]]))
        np.testing.assert_allclose(np.asarray(d), [[1.0, 2.0]])

    def test_periodic_distance(self):
        d = periodic_distance(10.0)(jnp.asarray([1.0]),
                                    jnp.asarray([[9.5], [4.0]]))
        np.testing.assert_allclose(np.asarray(d), [[1.5, 3.0]])


class TestNeighborhoodSelect:
    def test_selects_largest_weights(self, rng):
        loc = GaspariCohn((2.0,), _dist1d)
        grid = jnp.asarray([[10.0]])
        obs = jnp.asarray(np.linspace(0, 20, 41)[:, None])
        idx, w = neighborhood_select(loc, grid, obs, 5)
        full = np.asarray(loc.taper_weights(grid, obs))[0]
        np.testing.assert_allclose(np.sort(np.asarray(w[0]))[::-1],
                                   np.sort(full)[::-1][:5], rtol=1e-12)

    def test_pads_when_fewer_obs(self, rng):
        loc = GaspariCohn((2.0,), _dist1d)
        grid = jnp.asarray([[0.0]])
        obs = jnp.asarray([[0.5], [1.0]])
        idx, w = neighborhood_select(loc, grid, obs, 6)
        assert idx.shape == (1, 6) and w.shape == (1, 6)
        assert np.asarray(w[0, 2:]).max() == 0.0


class TestProfiling:
    def test_phase_accumulates_and_reports(self):
        from tpu_assim.utils import profiling

        profiling.reset()
        with profiling.phase("solve"):
            pass
        with profiling.phase("solve"):
            pass
        t = profiling.timings()
        assert t["solve"]["count"] == 2
        assert "solve" in profiling.report()
        profiling.reset()
        assert profiling.timings() == {}


class TestWindowKernelHelpers:
    """Pure host-side helpers of the window kernels."""

    def test_cheb_degree_monotone_in_conditioning(self):
        from tpu_assim.ops.window import cheb_degree_for

        degrees = [cheb_degree_for(lam) for lam in (1.5, 8.0, 43.0, 500.0)]
        assert degrees == sorted(degrees)
        assert degrees[0] >= 6 and degrees[-1] <= 96
        # tighter tolerance -> higher degree
        assert cheb_degree_for(8.0, tol=1e-10) > cheb_degree_for(8.0,
                                                                 tol=1e-4)

    def test_required_obs_block_2d_counts_bands(self, rng):
        from tpu_assim.ops.window import required_obs_block_2d

        # all obs at one y: every band containing it needs the full set
        obs_y = np.full(64, 5.0)
        grid_y = np.repeat(np.arange(8.0), 128)  # 8 rows of one tile each
        blk = required_obs_block_2d(obs_y, grid_y, radius_y=1.0)
        assert blk == 64
        # far-away band rows need (almost) nothing
        obs_y2 = np.linspace(0, 7, 64)
        blk2 = required_obs_block_2d(obs_y2, grid_y, radius_y=0.5)
        assert blk2 < 64
