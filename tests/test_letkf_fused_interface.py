"""Class-API fused-path oracle: LETKF(method='cheb'/'fused1d') through
``assimilate()`` must match LETKF(method='eigh') on full 4-D
[var, time, ens, grid] states.

This is the flagship speed feature of the interface layer: the fused paths
share one obs-space solve per column across every (var, time) slice and never
materialize the [grid, k, k] weights — mathematically identical to the
reference's estimate-then-apply contract
(/root/reference/pytassim/interface/letkf.py:104-148 +
/root/reference/pytassim/interface/base.py:256-278). The eigh path runs f64,
the fused paths f32, so parity is asserted at f32 accuracy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_assim import EnsembleState, Observation, LETKF
from tpu_assim.ops.localization import GaspariCohn
from tpu_assim.testing import dummy_obs_operator


def coord_dist(gc, oi):
    """Distance on the spatial coordinate (column 1; column 0 is time)."""
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def make_state(rng, n_var=2, n_time=3, n_ens=10, n_grid=60):
    data = rng.randn(n_var, n_time, n_ens, n_grid)
    return EnsembleState(
        jnp.asarray(data),
        times=jnp.arange(n_time, dtype=jnp.float64),
        grid_coords=jnp.arange(n_grid, dtype=jnp.float64)[:, None],
        var_names=("x", "y")[:n_var],
    )


def make_obs(rng, state, n_obs=24, noise=0.5):
    """Point obs of var 'x' at a sorted subset of grid columns."""
    obs_idx = np.sort(rng.choice(state.n_grid, size=n_obs, replace=False))
    truth = np.asarray(state.data[0].mean(axis=1))[:, obs_idx]  # [time, obs]
    obs_vals = truth + rng.normal(scale=np.sqrt(noise), size=truth.shape)

    def operator(obs, pseudo_state):
        return pseudo_state.data[0][:, :, obs_idx]  # [time, ens, obs]

    return Observation(
        jnp.asarray(obs_vals),
        covariance=jnp.full((n_obs,), noise),
        obs_coords=state.grid_coords[obs_idx],
        times=state.times,
        operator=operator,
    )


@pytest.fixture
def state(rng):
    return make_state(rng)


@pytest.fixture
def obs(rng, state):
    return make_obs(rng, state)


def assert_close_f32(a, b, atol=5e-4):
    a = np.asarray(a.data, dtype=np.float64)
    b = np.asarray(b.data, dtype=np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=atol * scale, rtol=0)


LOC = GaspariCohn((6.0,), coord_dist)


class TestFusedClassAPI:
    """method='cheb'/'fused1d' through assimilate() == method='eigh'."""

    @pytest.mark.parametrize("method", ["cheb", "fused1d"])
    def test_filtering_mode_multivar(self, state, obs, method):
        exact = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method="eigh", chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method=method, chunksize=None).assimilate(state, obs)
        assert fused.valid
        # filtering mode: one analysis time, ns = n_var slices > 1
        assert fused.n_times == 1
        assert fused.dtype == state.dtype
        assert_close_f32(fused, exact)

    @pytest.mark.parametrize("method", ["cheb", "fused1d"])
    def test_smoother_mode_multislice(self, state, obs, method):
        """Smoother mode: ns = n_var * n_time = 6 kernel slices, stacked
        multi-time obs (unsorted stacked coords exercise the defensive
        obs sort on the fused1d path)."""
        exact = LETKF(localization=LOC, inf_factor=1.1, max_obs=48,
                      method="eigh", smoother=True,
                      chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=LOC, inf_factor=1.1, max_obs=48,
                      method=method, smoother=True,
                      chunksize=None).assimilate(state, obs)
        assert fused.n_times == state.n_times
        assert_close_f32(fused, exact)

    @pytest.mark.parametrize("chunksize", [None, 17, 64])
    def test_cheb_chunked_equals_unchunked(self, state, obs, chunksize):
        full = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                     method="cheb", chunksize=None).assimilate(state, obs)
        chunked = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                        method="cheb",
                        chunksize=chunksize).assimilate(state, obs)
        np.testing.assert_allclose(np.asarray(chunked.data),
                                   np.asarray(full.data),
                                   rtol=1e-6, atol=1e-6)

    def test_cheb_window_selection(self, state, obs):
        exact = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method="eigh", chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method="cheb", selection="window",
                      chunksize=None).assimilate(state, obs)
        assert_close_f32(fused, exact)

    def test_estimate_weights_on_fused_instance_is_exact(self, state, obs):
        """Direct estimate_weights calls on a fused-configured instance
        return exact (eigh) [g, k, k] weight matrices."""
        alg_f = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method="cheb", chunksize=None)
        alg_e = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                      method="eigh", chunksize=None)
        sliced = state.sel_time_index(state.time_index(None))
        obs_t = obs.sel_time(float(state.times[-1]))
        ens_obs, filtered = alg_f._apply_obs_operator(sliced, [obs_t])
        w_f = alg_f.estimate_weights(sliced, filtered, ens_obs)
        w_e = alg_e.estimate_weights(sliced, filtered, ens_obs)
        assert w_f.shape == (state.n_grid, state.ens_size, state.ens_size)
        np.testing.assert_allclose(np.asarray(w_f), np.asarray(w_e),
                                   rtol=1e-10, atol=1e-10)

    def test_fused_config_validation(self):
        with pytest.raises(ValueError):
            LETKF(method="cheb")  # needs localization + max_obs
        with pytest.raises(ValueError):
            LETKF(method="fused1d", localization=LOC, max_obs=16,
                  weight_save_path="/tmp/w.h5")

    def test_gcinf_fused1d(self, rng, state, obs):
        """GC(z, inf, c) taper inside the monolithic window kernel
        (reference: pytassim/localization/gaspari_cohn.py:139-254)."""
        from tpu_assim.ops.localization import GaspariCohnInf

        loc = GaspariCohnInf(6.0, coord_dist)
        exact = LETKF(localization=loc, inf_factor=1.1, max_obs=16,
                      method="eigh", chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=loc, inf_factor=1.1, max_obs=16,
                      method="fused1d", chunksize=None).assimilate(state, obs)
        assert_close_f32(fused, exact)

    def test_pinned_degree_matches_auto_at_benchmark_conditioning(
        self, state, obs
    ):
        auto = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                     method="cheb", chunksize=None).assimilate(state, obs)
        pinned = LETKF(localization=LOC, inf_factor=1.1, max_obs=16,
                       method="cheb", cheb_degree=24,
                       chunksize=None).assimilate(state, obs)
        np.testing.assert_allclose(np.asarray(pinned.data),
                                   np.asarray(auto.data),
                                   rtol=1e-4, atol=1e-4)

    def test_single_var_single_time(self, rng):
        """ns = 1 through the class API (the [1, 1, k, g] degenerate case)."""
        state = make_state(rng, n_var=1, n_time=1, n_ens=8, n_grid=40)
        obs = make_obs(rng, state, n_obs=16)
        exact = LETKF(localization=LOC, inf_factor=1.05, max_obs=12,
                      method="eigh", chunksize=None).assimilate(state, obs)
        for method in ("cheb", "fused1d"):
            fused = LETKF(localization=LOC, inf_factor=1.05, max_obs=12,
                          method=method,
                          chunksize=None).assimilate(state, obs)
            assert_close_f32(fused, exact)


class TestExactnessGuards:
    """The silent-exactness hazards either fail loudly on the host
    (concrete inputs) or NaN-poison (traced inputs)."""

    def _clustered_workload(self, rng, g=600, o=64):
        """All obs clustered into the first 100 columns."""
        state = rng.randn(8, g)
        obs_x = np.sort(rng.uniform(0.0, 100.0, size=o))  # all in tile 0
        obs_idx = np.clip(np.rint(obs_x), 0, g - 1).astype("i4")
        obs_vals = rng.randn(o)
        obs_var = np.ones(o)
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        return tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx, grid_coords, obs_x[:, None]))

    def test_clustered_obs_exact_via_required_obs_block(self, rng):
        """The clustered workload matches the eigh path once max_obs covers
        the densest column's in-support count (26 here; 24 would truncate,
        which the strict guard rejects — test_max_obs_overflow_raises_
        concrete)."""
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.window import max_in_support_1d

        args = self._clustered_workload(rng)
        loc = GaspariCohn((8.0,), coord_dist)
        worst = max_in_support_1d(
            np.asarray(args[5])[:, 0], np.asarray(args[4])[:, 0], 8.0)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(loc, 1.1, method="fused1d",
                                    max_obs=worst, cheb_degree=24)(*args)
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert np.isfinite(np.asarray(fused)).all()
        # 2e-4: the f32 floor at this clustered conditioning (the same
        # value at degree 16 and 24)
        assert rel < 2e-4, rel

    def test_max_obs_overflow_raises_concrete(self, rng):
        """A clustered workload with too-small max_obs fails loudly on the
        concrete path instead of returning a plausible wrong analysis."""
        from tpu_assim.analysis import make_letkf_analysis

        args = self._clustered_workload(rng)
        loc = GaspariCohn((8.0,), coord_dist)
        fn = make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=24,
                                 cheb_degree=24)
        with pytest.raises(ValueError, match="in-support"):
            fn(*args)

    def test_max_obs_overflow_poisons_traced(self, rng):
        """The same overflow under an outer jit (traced coords) NaN-poisons
        exactly the overflowing columns."""
        from tpu_assim.ops.window import (
            letkf_window_analysis_fused, max_in_support_1d)

        args = self._clustered_workload(rng)
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = args
        k = state.shape[0]
        perts = state[:, obs_idx] - state[:, obs_idx].mean(0)
        innov = obs_vals - state[:, obs_idx].mean(0)
        mean = state.mean(0)
        sp = state - mean
        out = jax.jit(lambda *a: letkf_window_analysis_fused(
            *a, 8.0, k, nb=24))(
            perts, innov, obs_coords[:, 0], grid_coords[:, 0], sp, mean,
            jnp.asarray((k - 1) / 1.1, jnp.float32))
        out = np.asarray(out)
        ox = np.asarray(obs_coords)[:, 0]
        over = np.array([
            max_in_support_1d(ox, np.asarray(grid_coords)[c:c + 1, 0], 8.0)
            > 24 for c in range(out.shape[1])])
        assert over.any()
        assert np.isnan(out[:, over]).all(), "overflowing columns poison"
        assert np.isfinite(out[:, ~over]).all(), "other columns stay clean"

    def test_max_obs_strict_false_truncates_finite(self, rng):
        """strict=False restores the bounded-truncation behavior: finite
        output, close to (but not exactly) the eigh analysis."""
        from tpu_assim.analysis import make_letkf_analysis

        args = self._clustered_workload(rng)
        loc = GaspariCohn((8.0,), coord_dist)
        fused = make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=24,
                                    cheb_degree=24,
                                    max_obs_strict=False)(*args)
        assert np.isfinite(np.asarray(fused)).all()
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert rel < 5e-3, rel  # truncation error, not garbage

    def test_asymmetric_support_window_clamps_exact(self, rng):
        """A column whose in-support obs sit almost all on one side: the
        rank-centered window alone would truncate even though the total
        fits; the support clamp keeps it exact (matches eigh)."""
        from tpu_assim.analysis import make_letkf_analysis

        g = 256
        state = rng.randn(8, g)
        # 12 obs packed just left of x=100, 2 just right; radius 4 =>
        # support (92, 108); nb=16 holds all 14, but center-rank windows
        # at columns right of the cluster shift right and would drop the
        # leftmost obs without the clamp
        obs_x = np.sort(np.concatenate([
            rng.uniform(93.0, 99.5, size=12), rng.uniform(100.5, 103.0, 2),
            rng.uniform(150.0, 250.0, size=30),
        ]))
        obs_idx = np.clip(np.rint(obs_x), 0, g - 1).astype("i4")
        obs_vals = rng.randn(obs_x.size)
        obs_var = np.ones(obs_x.size)
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        args = tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx, grid_coords,
            obs_x[:, None]))
        loc = GaspariCohn((4.0,), coord_dist)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=16,
                                    cheb_degree=24)(*args)
        assert np.isfinite(np.asarray(fused)).all()
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert rel < 2e-4, rel

    def test_overflowing_block_poisons_not_silent(self, rng):
        """A direct call with a too-small window NaN-poisons the columns
        that would drop in-support observations, never silently."""
        from tpu_assim.ops.window import letkf_window_analysis_fused

        args = self._clustered_workload(rng)
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = args
        k = state.shape[0]
        perts = state[:, obs_idx] - state[:, obs_idx].mean(0)
        innov = obs_vals - state[:, obs_idx].mean(0)
        mean = state.mean(0)
        sp = state - mean
        out = letkf_window_analysis_fused(
            perts, innov, obs_coords[:, 0], grid_coords[:, 0], sp, mean,
            jnp.asarray((k - 1) / 1.1, jnp.float32), 8.0, k,
            nb=8,
        )
        out = np.asarray(out)
        assert np.isnan(out[:, 20:80]).all()     # inside the obs cluster
        assert np.isfinite(out[:, 256:]).all()   # obs-free columns fine

    def test_unsorted_obs_raises_on_concrete_call(self, rng):
        from tpu_assim.analysis import make_letkf_analysis

        args = list(self._clustered_workload(rng))
        args[5] = args[5][::-1]  # descending coords
        loc = GaspariCohn((8.0,), coord_dist)
        fn = make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=24)
        with pytest.raises(ValueError, match="sorted"):
            fn(*args)

    def test_unsorted_obs_poisons_window_selection(self, rng):
        """neighborhood_select_window NaN-poisons its weights on unsorted
        coords instead of returning wrong neighborhoods."""
        from tpu_assim.ops.localization import neighborhood_select_window

        g, o = 50, 16
        gi = jnp.asarray(np.stack([np.zeros(g), np.arange(g, dtype="f8")], 1))
        ox = np.sort(rng.uniform(0, g, size=o))[::-1].copy()
        oi = jnp.asarray(np.stack([np.zeros(o), ox], 1))
        loc = GaspariCohn((5.0,), coord_dist)
        _, w = neighborhood_select_window(loc, gi, oi, 8)
        assert np.isnan(np.asarray(w)).all()

    @pytest.mark.parametrize("trial", range(3))
    def test_adversarial_layouts_match_eigh(self, rng, trial):
        """Clustered-head plus spread-tail obs layouts: the window analysis
        with nb at the exact in-support maximum matches the eigh path."""
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.window import max_in_support_1d

        rs = np.random.RandomState(100 + trial)
        g, o = 300, 40
        obs_x = np.sort(np.concatenate([
            rs.uniform(0, 30, size=o // 2),       # clustered head
            rs.uniform(0, g, size=o - o // 2),    # spread tail
        ]))
        obs_idx = np.clip(np.rint(obs_x), 0, g - 1).astype("i4")
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        args = tuple(jnp.asarray(a) for a in (
            rs.randn(6, g), rs.randn(o), np.ones(o), obs_idx, grid_coords,
            obs_x[:, None]))
        loc = GaspariCohn((6.0,), coord_dist)
        nb = max_in_support_1d(obs_x, grid_coords[:, 0], 6.0)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=nb,
                                    cheb_degree=32)(*args)
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert rel < 2e-4, rel


class TestStaticGeometry:
    """geometry=(obs_idx, grid_coords, obs_coords) binds the obs network
    as XLA constants (the cycled-DA prologue amortization):
    the bound function must be bitwise-identical to the unbound path and
    run the same host-side hardening at build time."""

    def _workload(self, rng, g=512, o=64):
        state = rng.randn(8, g)
        obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype("i4")
        obs_vals = rng.randn(o)
        obs_var = np.ones(o)
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        obs_coords = grid_coords[obs_idx]
        return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords

    def test_bound_matches_unbound(self, rng):
        from tpu_assim.analysis import make_letkf_analysis

        w = self._workload(rng)
        loc = GaspariCohn((8.0,), coord_dist)
        unbound = make_letkf_analysis(loc, 1.1, method="fused1d",
                                      max_obs=16, cheb_degree=16)
        bound = make_letkf_analysis(loc, 1.1, method="fused1d",
                                    max_obs=16, cheb_degree=16,
                                    geometry=(w[3], w[4], w[5]))
        a = np.asarray(unbound(*(jnp.asarray(x) for x in w)))
        b = np.asarray(bound(jnp.asarray(w[0]), jnp.asarray(w[1]),
                             jnp.asarray(w[2])))
        np.testing.assert_array_equal(a, b)

    def test_bound_hardening_raises_at_build(self, rng):
        from tpu_assim.analysis import make_letkf_analysis

        w = self._workload(rng)
        loc = GaspariCohn((8.0,), coord_dist)
        with pytest.raises(ValueError, match="in-support"):
            make_letkf_analysis(loc, 1.1, method="fused1d", max_obs=2,
                                geometry=(w[3], w[4], w[5]))

    def test_bound_cycle_step(self, rng):
        from tpu_assim.analysis import make_cycle_step, make_letkf_analysis
        from tpu_assim.models import Lorenz96, RK4Integrator

        w = self._workload(rng, g=128, o=24)
        loc = GaspariCohn((8.0,), coord_dist)
        cyc = make_cycle_step(
            RK4Integrator(Lorenz96(), dt=0.01), 2, loc, inf_factor=1.1,
            method="fused1d", max_obs=16,
            geometry=(w[3], w[4], w[5]),
        )
        out = cyc(jnp.asarray(w[0]), jnp.asarray(w[1]), jnp.asarray(w[2]))
        assert out.shape == w[0].shape
        assert np.isfinite(np.asarray(out)).all()


class TestStripLETKF2D:
    """x-strip domain decomposition over the fused2d kernel
    (make_strip_letkf_2d): strips + scatter-back must reproduce the
    single-call fused2d analysis and the eigh oracle."""

    def _workload(self, rng, nr=32, nc=32, o=64, k=8):
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        cells = np.sort(rng.choice(nr * nc, size=o, replace=False)
                        ).astype("i4")
        obs_xy = grid_xy[cells]
        state = rng.randn(k, nr * nc)
        obs_vals = rng.randn(o)
        obs_var = np.ones(o)
        return state, obs_vals, obs_var, cells, grid_xy, obs_xy

    def test_strips_match_fused2d_and_eigh(self, rng):
        from tpu_assim.analysis import make_letkf_analysis, \
            make_strip_letkf_2d
        from tpu_assim.ops.window import max_in_support_2d

        w = self._workload(rng)
        state, obs_vals, obs_var, cells, grid_xy, obs_xy = w

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0, 3.0), dist2)
        # strip tiles are taller than global tiles (128 cells of an 8-wide
        # strip = 16 rows), so their y-bands hold more slot-consuming obs:
        # size nb for the worst of both tilings (the strict build raises
        # otherwise — test_strip_overflow_raises)
        nb = max(8, max_in_support_2d(obs_xy, grid_xy, 3.0, 3.0)) + 8
        args = tuple(jnp.asarray(a) for a in w)
        dense2d = make_letkf_analysis(loc, 1.1, method="fused2d",
                                      max_obs=nb, cheb_degree=24)(*args)
        eigh = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        strips = make_strip_letkf_2d(
            loc, (cells, grid_xy, obs_xy), n_strips=4, inf_factor=1.1,
            max_obs=nb, cheb_degree=24, tile=128,
        )(jnp.asarray(state), jnp.asarray(obs_vals), jnp.asarray(obs_var))
        scale = float(np.abs(np.asarray(eigh)).max())
        assert np.isfinite(np.asarray(strips)).all()
        # strips vs the one-call fused2d: same kernel math, different
        # blocking — agreement to f32 reassociation noise
        np.testing.assert_allclose(np.asarray(strips), np.asarray(dense2d),
                                   rtol=5e-5, atol=5e-5)
        rel = np.abs(np.asarray(strips) - np.asarray(eigh)).max() / scale
        assert rel < 5e-4, rel

    def test_strip_overflow_raises(self, rng):
        from tpu_assim.analysis import make_strip_letkf_2d

        w = self._workload(rng)
        state, obs_vals, obs_var, cells, grid_xy, obs_xy = w

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0, 3.0), dist2)
        with pytest.raises(ValueError, match="in-support"):
            make_strip_letkf_2d(loc, (cells, grid_xy, obs_xy), n_strips=4,
                                inf_factor=1.1, max_obs=2)


class TestCorrelatedRFastPaths:
    """Correlated R through the functional entry points: every solver
    method consumes the Cholesky-whitened obs space (the reference's uniform
    mul_rcinv contract, observation.py:247-271, now on the fast paths)."""

    def _workload(self, rng, ens=8, g=64, o=20):
        state = rng.normal(size=(ens, g))
        obs_idx = np.sort(rng.choice(g, size=o, replace=False))
        obs_vals = rng.normal(size=o)
        a = rng.randn(o, o) * 0.1
        cov = a @ a.T + np.eye(o)
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        obs_coords = grid_coords[obs_idx]
        return (state, obs_vals, cov, obs_idx.astype("i4"), grid_coords,
                obs_coords)

    @pytest.mark.parametrize("method", ["eigh", "newton", "cheb", "fused1d"])
    def test_correlated_equals_prewhitened(self, rng, method):
        """Passing the full R equals hand-whitening obs space with unit
        variances... checked against the eigh path on the whitened problem
        via a diagonal-R run of the same method with pre-whitened inputs is
        impossible through this API (whitening mixes the operator), so the
        oracle is the eigh method with the same full R."""
        from tpu_assim.analysis import make_letkf_analysis

        w = self._workload(rng)
        args = tuple(jnp.asarray(a) for a in w)
        loc = GaspariCohn((6.0,), coord_dist)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        out = make_letkf_analysis(loc, 1.1, method=method, max_obs=20,
                                  cheb_degree=24, newton_iters=40)(*args)
        rel = float(np.abs(np.asarray(out) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        tol = 1e-9 if method in ("eigh", "newton") else 2e-4
        assert rel < tol, (method, rel)

    def test_correlated_changes_analysis(self, rng):
        """The off-diagonal correlations actually matter (guard against the
        whitening silently degenerating to the diagonal)."""
        from tpu_assim.analysis import make_letkf_analysis

        state, obs_vals, cov, obs_idx, gc_, oc_ = self._workload(rng)
        loc = GaspariCohn((6.0,), coord_dist)
        fn = make_letkf_analysis(loc, 1.1, method="eigh")
        full = fn(*map(jnp.asarray, (state, obs_vals, cov, obs_idx, gc_,
                                     oc_)))
        diag = fn(*map(jnp.asarray, (state, obs_vals, np.diag(cov), obs_idx,
                                     gc_, oc_)))
        assert not np.allclose(np.asarray(full), np.asarray(diag),
                               atol=1e-6)


class TestFused3DLocalization:
    """>= 3-D localization through the fused 2-D kernel:
    coordinate dims beyond (x, y) — the COSMO (rlat, rlon, vgrid) case —
    contribute product taper factors; band/window selection stays on
    (y, x). Parity vs the eigh path at f32 accuracy."""

    def _workload_3d(self, rng, nx=8, ny=8, nz=4, o=48, ens=8):
        g = nx * ny * nz
        zz, yy, xx = np.meshgrid(np.arange(nz, dtype="f8"),
                                 np.arange(ny, dtype="f8"),
                                 np.arange(nx, dtype="f8"), indexing="ij")
        grid_xyz = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
        state = rng.normal(size=(ens, g))
        obs_pos = rng.choice(g, size=o, replace=False)
        obs_xyz = grid_xyz[obs_pos] + rng.uniform(-0.3, 0.3, size=(o, 3))
        obs_vals = rng.normal(size=o)
        obs_var = rng.uniform(0.5, 1.5, size=o)
        return (state, obs_vals, obs_var, obs_pos.astype("i4"), grid_xyz,
                obs_xyz)

    @staticmethod
    def _dist3(gc, oi):
        return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                          jnp.abs(oi[:, 2] - gc[2]),
                          jnp.abs(oi[:, 3] - gc[3])], 0)

    def test_fused2d_3coords_matches_eigh(self, rng):
        from tpu_assim.analysis import make_letkf_analysis

        w = self._workload_3d(rng)
        loc = GaspariCohn((2.5, 2.5, 1.5), self._dist3)
        args = tuple(jnp.asarray(a) for a in w)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(loc, 1.1, method="fused2d",
                                    max_obs=48, cheb_degree=20)(*args)
        a = np.asarray(fused)
        b = np.asarray(exact)
        assert np.isfinite(a).all()
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        assert rel < 2e-4, rel

    def test_fused2d_3coords_class_api(self, rng):
        """The class API routes 3-coordinate states through the extended
        kernel (the COSMO (rlat, rlon, vgrid) shape)."""
        w = self._workload_3d(rng)
        state, obs_vals, obs_var, obs_idx, grid_xyz, obs_xyz = w
        ens, g = state.shape
        st = EnsembleState(
            jnp.asarray(state[None, None]),
            times=jnp.arange(1, dtype=jnp.float64),
            grid_coords=jnp.asarray(grid_xyz),
            var_names=("x",),
        )
        obs_idx_np = np.asarray(obs_idx)

        def operator(obs, pseudo_state):
            return pseudo_state.data[0][:, :, obs_idx_np]

        obs = Observation(
            jnp.asarray(obs_vals[None, :]),
            covariance=jnp.asarray(obs_var),
            obs_coords=jnp.asarray(obs_xyz),
            times=st.times,
            operator=operator,
        )
        loc = GaspariCohn((2.5, 2.5, 1.5), self._dist3)
        exact = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="eigh", chunksize=None).assimilate(st, obs)
        fused = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="fused2d",
                      chunksize=None).assimilate(st, obs)
        a = np.asarray(fused.data, np.float64)
        b = np.asarray(exact.data, np.float64)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=5e-4 * np.abs(b).max(),
                                   rtol=0)

    def test_fused2d_3coords_vertical_radius_matters(self, rng):
        """The vertical taper factor is actually applied: shrinking the
        z-radius changes the analysis (no silent 2-D fallback)."""
        from tpu_assim.analysis import make_letkf_analysis

        w = self._workload_3d(rng)
        args = tuple(jnp.asarray(a) for a in w)
        wide = make_letkf_analysis(
            GaspariCohn((2.5, 2.5, 50.0), self._dist3), 1.1,
            method="fused2d", max_obs=48, cheb_degree=20)(*args)
        narrow = make_letkf_analysis(
            GaspariCohn((2.5, 2.5, 0.5), self._dist3), 1.1,
            method="fused2d", max_obs=48, cheb_degree=20)(*args)
        assert not np.allclose(np.asarray(wide), np.asarray(narrow),
                               atol=1e-6)


class TestMonolithic2DKernel:
    """The 2-D window kernel (y-band blocks + x-windows + per-dimension
    product taper) vs the exact eigh analysis on a 2-D domain (reference
    per-dimension radii behavior: pytassim/localization/gaspari_cohn.py:
    124-134)."""

    def _workload_2d(self, rng, nr=24, nc=24, o=80, ens=8):
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)   # row-major
        state = rng.normal(size=(ens, g))
        obs_pos = rng.choice(g, size=o, replace=False)
        obs_xy = grid_xy[obs_pos] + rng.uniform(-0.4, 0.4, size=(o, 2))
        obs_vals = rng.normal(size=o)
        obs_var = rng.uniform(0.5, 1.5, size=o)
        return (state, obs_vals, obs_var, obs_pos.astype("i4"), grid_xy,
                obs_xy)

    @pytest.mark.parametrize("radii", [(4.0, 4.0), (5.0, 3.0)])
    def test_matches_eigh_2d(self, rng, radii):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.window import (
            letkf_window_analysis_fused_2d, required_obs_block_2d)

        rx, ry = radii
        w = self._workload_2d(rng)
        state, obs_vals, obs_var, obs_idx, grid_xy, obs_xy = w

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((rx, ry), dist2)
        args = tuple(jnp.asarray(a) for a in w)
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)

        k = state.shape[0]
        ens_obs = state[:, obs_idx]
        rcinv = 1.0 / np.sqrt(obs_var)
        mo = ens_obs.mean(0)
        perts = (ens_obs - mo) * rcinv
        innov = (obs_vals - mo) * rcinv
        mean_s = state.mean(0)
        sp = state - mean_s
        blk = required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], ry)
        out = letkf_window_analysis_fused_2d(
            jnp.asarray(perts), jnp.asarray(innov), jnp.asarray(obs_xy),
            jnp.asarray(grid_xy), jnp.asarray(sp), jnp.asarray(mean_s),
            jnp.asarray((k - 1) / 1.1, jnp.float32), rx, ry, k,
            obs_block=blk, nb=64, degree=24, 
        )
        rel = float(np.abs(np.asarray(out) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert np.isfinite(np.asarray(out)).all()
        assert rel < 2e-4, rel

    def test_band_overflow_poisons(self, rng):
        from tpu_assim.ops.window import letkf_window_analysis_fused_2d

        w = self._workload_2d(rng, o=80)
        state, obs_vals, obs_var, obs_idx, grid_xy, obs_xy = w
        k = state.shape[0]
        ens_obs = state[:, obs_idx]
        mo = ens_obs.mean(0)
        out = letkf_window_analysis_fused_2d(
            jnp.asarray(ens_obs - mo), jnp.asarray(obs_vals - mo),
            jnp.asarray(obs_xy), jnp.asarray(grid_xy),
            jnp.asarray(state - state.mean(0)), jnp.asarray(state.mean(0)),
            jnp.asarray((k - 1) / 1.1, jnp.float32), 4.0, 4.0, k,
            obs_block=8, nb=8, # far too small
        )
        assert np.isnan(np.asarray(out)).any()

    def test_band_overflow_below_128_poisons(self, rng):
        """Band population above obs_block (but below the padded widths a
        blocked layout might round up to) must NaN-poison, not silently
        truncate."""
        from tpu_assim.ops.window import (
            letkf_window_analysis_fused_2d, required_obs_block_2d)

        w = self._workload_2d(rng, o=80)
        state, obs_vals, obs_var, obs_idx, grid_xy, obs_xy = w
        k = state.shape[0]
        ens_obs = state[:, obs_idx]
        mo = ens_obs.mean(0)
        need = int(required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], 4.0))
        assert 16 < need <= 80  # the workload genuinely needs more than 16
        out = letkf_window_analysis_fused_2d(
            jnp.asarray(ens_obs - mo), jnp.asarray(obs_vals - mo),
            jnp.asarray(obs_xy), jnp.asarray(grid_xy),
            jnp.asarray(state - state.mean(0)), jnp.asarray(state.mean(0)),
            jnp.asarray((k - 1) / 1.1, jnp.float32), 4.0, 4.0, k,
            # nb=full so the strict x-window guard cannot fire — only the
            # band-capacity guard distinguishes pass from silent truncation
            obs_block=16, nb=80, degree=12, 
        )
        assert np.isnan(np.asarray(out)).any()

    def test_obs_block_required(self, rng):
        from tpu_assim.ops.window import letkf_window_analysis_fused_2d

        with pytest.raises(ValueError, match="obs_block"):
            letkf_window_analysis_fused_2d(
                jnp.zeros((4, 8)), jnp.zeros(8), jnp.zeros((8, 2)),
                jnp.zeros((16, 2)), jnp.zeros((4, 16)), jnp.zeros(16),
                jnp.asarray(3.0, jnp.float32), 4.0, 4.0, 4, obs_block=0,
            )


class TestFused2DClassAPI:
    """LETKF(method='fused2d') through assimilate() on a 2-D domain equals
    method='eigh' — the class-API route to the 2-D monolithic kernel."""

    def test_fused2d_assimilate(self, rng):
        nr, nc, n_ens, n_obs = 16, 16, 8, 48
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        data = rng.randn(1, 1, n_ens, g)
        state = EnsembleState(jnp.asarray(data),
                              times=jnp.asarray([0.0]),
                              grid_coords=jnp.asarray(grid_xy))
        obs_idx = np.sort(rng.choice(g, size=n_obs, replace=False))
        truth = np.asarray(state.data[0].mean(axis=1))[:, obs_idx]
        obs_vals = truth + rng.normal(scale=0.5, size=truth.shape)

        def operator(obs, pseudo_state):
            return pseudo_state.data[0][:, :, obs_idx]

        obs = Observation(jnp.asarray(obs_vals),
                          covariance=jnp.full((n_obs,), 0.5),
                          obs_coords=jnp.asarray(grid_xy[obs_idx]),
                          times=state.times, operator=operator)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((4.0, 3.0), dist2)
        exact = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="eigh", chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="fused2d",
                      chunksize=None).assimilate(state, obs)
        assert_close_f32(fused, exact)

    def test_fused2d_functional(self, rng):
        from tpu_assim.analysis import make_letkf_analysis

        nr = nc = 20
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        state = rng.normal(size=(8, g))
        obs_idx = rng.choice(g, size=60, replace=False)
        obs_vals = rng.normal(size=60)
        obs_var = np.ones(60)
        obs_xy = grid_xy[obs_idx]

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((4.0,), dist2)
        args = tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx.astype("i4"), grid_xy,
            obs_xy))
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(loc, 1.1, method="fused2d", max_obs=60,
                                    cheb_degree=32)(*args)
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert rel < 2e-4, rel


class TestFused2DMultiSlice:
    """fused2d through assimilate() on a multi-var multi-time state
    (ns = v*t kernel slices sharing the obs-space solve), smoother mode
    included."""

    def test_fused2d_multivar_smoother(self, rng):
        nr, nc, n_ens, n_obs, n_time = 12, 12, 8, 36, 2
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        data = rng.randn(2, n_time, n_ens, g)
        state = EnsembleState(jnp.asarray(data),
                              times=jnp.arange(n_time, dtype=jnp.float64),
                              grid_coords=jnp.asarray(grid_xy),
                              var_names=("x", "y"))
        obs_idx = np.sort(rng.choice(g, size=n_obs, replace=False))
        truth = np.asarray(state.data[0].mean(axis=1))[:, obs_idx]
        obs_vals = truth + rng.normal(scale=0.5, size=truth.shape)

        def operator(obs, pseudo_state):
            return pseudo_state.data[0][:, :, obs_idx]

        obs = Observation(jnp.asarray(obs_vals),
                          covariance=jnp.full((n_obs,), 0.5),
                          obs_coords=jnp.asarray(grid_xy[obs_idx]),
                          times=state.times, operator=operator)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.5,), dist2)
        for smoother, max_obs in ((False, 36), (True, 72)):
            exact = LETKF(localization=loc, inf_factor=1.1, max_obs=max_obs,
                          method="eigh", smoother=smoother,
                          chunksize=None).assimilate(state, obs)
            fused = LETKF(localization=loc, inf_factor=1.1, max_obs=max_obs,
                          method="fused2d", smoother=smoother,
                          chunksize=None).assimilate(state, obs)
            assert_close_f32(fused, exact)


class TestFused2DTraceable:
    """With an explicit obs_block the fused2d analysis is fully traceable —
    usable inside an outer jit/scan (the cycled-DA composition)."""

    def test_fused2d_inside_scan(self, rng):
        import jax
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.window import required_obs_block_2d

        nr = nc = 16
        g = nr * nc
        ens, o = 8, 48
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        state = jnp.asarray(rng.normal(size=(ens, g)).astype("f4"))
        obs_idx = rng.choice(g, size=o, replace=False).astype("i4")
        obs_xy = grid_xy[obs_idx]
        obs_seq = jnp.asarray(rng.normal(size=(3, o)).astype("f4"))
        ovar = jnp.ones(o, jnp.float32)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0,), dist2)
        blk = required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], 3.0)
        analyse = make_letkf_analysis(loc, 1.1, method="fused2d",
                                      max_obs=48, cheb_degree=16,
                                      obs_block=blk)
        args = (ovar, jnp.asarray(obs_idx), jnp.asarray(grid_xy),
                jnp.asarray(obs_xy))

        @jax.jit
        def cycles(s0):
            def body(s, obs_vals):
                return analyse(s, obs_vals, *args), None

            out, _ = jax.lax.scan(body, s0, obs_seq)
            return out

        scanned = cycles(state)
        # equals three sequential direct calls
        direct = state
        for c in range(3):
            direct = analyse(direct, obs_seq[c], *args)
        np.testing.assert_allclose(np.asarray(scanned), np.asarray(direct),
                                   rtol=1e-5, atol=1e-5)
        assert np.isfinite(np.asarray(scanned)).all()


class TestSmootherConditioning:
    """4-D (stacked obs times) conditioning: the auto Chebyshev degree
    must engage its high-degree regime (~40+, docs/solvers.md) and the
    fused result must stay at f32 accuracy vs the eigh oracle — the
    smoother coverage."""

    def test_auto_degree_engages_and_matches_eigh(self, rng, monkeypatch):
        state = make_state(rng, n_var=2, n_time=3, n_ens=10, n_grid=60)
        obs = make_obs(rng, state, n_obs=40)
        captured = []
        orig = LETKF._auto_cheb_degree

        def spy(self, *a, **k):
            d = orig(self, *a, **k)
            captured.append(d)
            return d

        monkeypatch.setattr(LETKF, "_auto_cheb_degree", spy)
        exact = LETKF(localization=LOC, inf_factor=1.1, max_obs=80,
                      method="eigh", smoother=True,
                      chunksize=None).assimilate(state, obs)
        fused = LETKF(localization=LOC, inf_factor=1.1, max_obs=80,
                      method="fused1d", smoother=True, cheb_degree=None,
                      chunksize=None).assimilate(state, obs)
        assert captured, "auto degree must have been measured"
        assert max(captured) >= 40, captured
        assert_close_f32(fused, exact)


class TestDMABlockEdges:
    """The banded 2-D block path's exactness at its edges: obs pinned
    EXACTLY at band boundaries, banded vs whole-table compared BITWISE."""

    def test_2d_banded_equals_whole_table_bitwise(self, rng):
        """The 2-D banded path vs the whole-table path (obs_block >=
        o): identical selection, bitwise-equal analysis — with obs pinned
        exactly at band boundaries and odd band offsets."""
        from tpu_assim.ops.window import (
            letkf_window_analysis_fused_2d,
            max_in_support_2d,
            required_obs_block_2d,
        )

        nr = nc = 16
        g = nr * nc
        ry = rx = 3.0
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        obs = [  # y pinned exactly at band cutoffs of the (single) tile
            [5.0, 0.0 - 2 * ry], [5.0, 0.0 - 2 * ry + 1e-3],
            [7.0, 15.0 + 2 * ry - 1e-3], [7.0, 15.0 + 2 * ry],
        ]
        obs += [[rng.uniform(0, 15), rng.uniform(0, 15)]
                for _ in range(29)]  # odd count
        obs_xy = np.asarray(obs)
        o = len(obs_xy)
        k = 8
        state = rng.normal(size=(k, g))
        perts = rng.normal(size=(k, o))
        innov = rng.normal(size=o)
        mean = state.mean(0)
        sp = state - mean
        # nb = o: at this tiny grid the per-tile y-band spans the whole
        # domain, so the two modes' strict candidate counts only agree
        # with an all-covering window — the test targets the band
        # slicing/offset arithmetic, not the window truncation
        nb = o
        assert max_in_support_2d(obs_xy, grid_xy, rx, ry) <= nb
        blk = required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], ry)
        args = (jnp.asarray(perts, jnp.float32),
                jnp.asarray(innov, jnp.float32),
                jnp.asarray(obs_xy, jnp.float32),
                jnp.asarray(grid_xy, jnp.float32),
                jnp.asarray(sp, jnp.float32),
                jnp.asarray(mean, jnp.float32),
                jnp.asarray((k - 1) / 1.1, jnp.float32))
        kw = dict(radius_x=rx, radius_y=ry, ens_size=k, nb=nb, degree=10)
        banded = letkf_window_analysis_fused_2d(*args, obs_block=int(blk),
                                                **kw)
        whole = letkf_window_analysis_fused_2d(*args, obs_block=o, **kw)
        assert np.isfinite(np.asarray(banded)).all()
        # No bitwise twin exists in 2-D (the whole-table path contracts a
        # different table width, so the reduction tree differs); the two
        # must agree at the f32 reduction-rounding floor — a few ulp,
        # NOT a truncation-sized gap (a dropped obs shows up at ~1e-1).
        np.testing.assert_allclose(np.asarray(banded), np.asarray(whole),
                                   atol=1e-6, rtol=0)


class TestFused2DClassStrips:
    """LETKF(method='fused2d') auto-splits wide grids into x-strips (the
    production path): class-level strips == direct
    fused2d == eigh, and the auto rule engages on wide grids only."""

    def _wide_workload(self, rng, nr=8, nc=520, n_ens=8, n_obs=160):
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        data = rng.randn(1, 1, n_ens, g)
        state = EnsembleState(jnp.asarray(data),
                              times=jnp.asarray([0.0]),
                              grid_coords=jnp.asarray(grid_xy))
        obs_idx = np.sort(rng.choice(g, size=n_obs, replace=False))
        truth = np.asarray(state.data[0].mean(axis=1))[:, obs_idx]
        obs_vals = truth + rng.normal(scale=0.5, size=truth.shape)

        def operator(obs, pseudo_state):
            return pseudo_state.data[0][:, :, obs_idx]

        obs = Observation(jnp.asarray(obs_vals),
                          covariance=jnp.full((n_obs,), 0.5),
                          obs_coords=jnp.asarray(grid_xy[obs_idx]),
                          times=state.times, operator=operator)
        return state, obs

    def test_auto_strips_match_direct_and_eigh(self, rng):
        state, obs = self._wide_workload(rng)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0, 3.0), dist2)
        exact = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="eigh", chunksize=None).assimilate(state, obs)
        # auto: 520 distinct x -> 2 strips; assert the strip path engaged
        auto = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                     method="fused2d", chunksize=None)
        out_auto = auto.assimilate(state, obs)
        assert auto._strip_cache is not None, "auto-strips did not engage"
        assert_close_f32(out_auto, exact)
        # pinned single-kernel (no strips) must agree too
        direct = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                       method="fused2d", chunksize=None, n_strips=1)
        out_dir = direct.assimilate(state, obs)
        assert direct._strip_cache is None
        assert_close_f32(out_auto, out_dir, atol=1e-5)

    def test_narrow_grid_takes_single_kernel(self, rng):
        state, obs = self._wide_workload(rng, nr=16, nc=16, n_obs=48)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0, 3.0), dist2)
        letkf = LETKF(localization=loc, inf_factor=1.1, max_obs=48,
                      method="fused2d", chunksize=None)
        letkf.assimilate(state, obs)
        assert letkf._strip_cache is None

    def test_pinned_strips_multislice(self, rng):
        """n_strips pinned explicitly, multi-var multi-time state (ns > 1
        kernel slices through the strip apply)."""
        nr, nc, n_ens, n_obs = 6, 96, 8, 80
        g = nr * nc
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        data = rng.randn(2, 2, n_ens, g)
        state = EnsembleState(jnp.asarray(data),
                              times=jnp.asarray([0.0, 1.0]),
                              grid_coords=jnp.asarray(grid_xy),
                              var_names=("x", "y"))
        obs_idx = np.sort(rng.choice(g, size=n_obs, replace=False))
        truth = np.asarray(state.data[0].mean(axis=1))[:, obs_idx]
        obs_vals = truth + rng.normal(scale=0.5, size=truth.shape)

        def operator(obs, pseudo_state):
            return pseudo_state.data[0][:, :, obs_idx]

        obs = Observation(jnp.asarray(obs_vals),
                          covariance=jnp.full((n_obs,), 0.5),
                          obs_coords=jnp.asarray(grid_xy[obs_idx]),
                          times=state.times, operator=operator)

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.0, 3.0), dist2)
        exact = LETKF(localization=loc, inf_factor=1.1, max_obs=64,
                      method="eigh", chunksize=None).assimilate(state, obs)
        strips = LETKF(localization=loc, inf_factor=1.1, max_obs=64,
                       method="fused2d", chunksize=None, n_strips=3)
        out = strips.assimilate(state, obs)
        assert strips._strip_cache is not None
        assert_close_f32(out, exact)
