"""Interface-layer tests mirroring the reference's algorithm-equivalence
oracles (/root/reference/tests/unit_tests/interface/):

* LETKF == ETKF when localization is None (test_letkf.py:64-70)
* LETKF == ETKF under all-weights-one localization (test_letkf.py:95-104)
* KETKF(linear kernel) == ETKF (test_ketkf.py)
* IEnKS(1 iter, identity model) == ETKF (test_ienks.py:215-238)
* chunked == unchunked grid processing (the dask-parity analog,
  test_etkf.py:109)
* weight checkpoint roundtrip (test_letkf.py:173-197)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_assim import (
    EnsembleState,
    Observation,
    ETKF,
    LETKF,
    KETKF,
    LKETKF,
    IEnKSTransform,
    IEnKSBundle,
    LocalizedIEnKSTransform,
    LocalizedIEnKSBundle,
)
from tpu_assim.ops.kernels import LinearKernel, GaussKernel
from tpu_assim.ops.localization import GaspariCohn
from tpu_assim.testing import dummy_obs_operator, dummy_model, dummy_distance


def make_state(rng, n_var=2, n_time=3, n_ens=10, n_grid=40):
    data = rng.randn(n_var, n_time, n_ens, n_grid)
    return EnsembleState(
        jnp.asarray(data),
        times=jnp.arange(n_time, dtype=jnp.float64),
        grid_coords=jnp.arange(n_grid, dtype=jnp.float64)[:, None],
        var_names=("x", "y")[:n_var],
    )


def make_obs(rng, state, noise=0.5):
    # observation = ens-mean of var x + N(0, 0.5) noise, diag cov 0.5 — the
    # reference's fixture recipe (tests/data/create_test_data.py:20-96)
    truth = np.asarray(state.data[0].mean(axis=1))  # [time, grid]
    obs_vals = truth + rng.normal(scale=np.sqrt(noise), size=truth.shape)
    return Observation(
        jnp.asarray(obs_vals),
        covariance=jnp.full((state.n_grid,), noise),
        obs_coords=state.grid_coords,
        times=state.times,
        operator=dummy_obs_operator(),
    )


@pytest.fixture
def state(rng):
    return make_state(rng)


@pytest.fixture
def obs(rng, state):
    return make_obs(rng, state)


def assert_states_close(a, b, atol=1e-10):
    np.testing.assert_allclose(
        np.asarray(a.data), np.asarray(b.data), atol=atol, rtol=1e-10
    )


class TestETKF:
    def test_assimilate_returns_valid_state(self, state, obs):
        analysis = ETKF(inf_factor=1.1).assimilate(state, obs)
        assert analysis.valid
        # filtering mode: analysis at last time only
        assert analysis.n_times == 1
        assert float(analysis.times[0]) == float(state.times[-1])

    def test_smoother_keeps_time_window(self, state, obs):
        analysis = ETKF(inf_factor=1.1, smoother=True).assimilate(state, obs)
        assert analysis.n_times == state.n_times

    def test_no_obs_returns_background(self, state):
        with pytest.warns(UserWarning):
            analysis = ETKF().assimilate(state, [])
        assert analysis is state

    def test_analysis_reduces_spread(self, state, obs):
        analysis = ETKF().assimilate(state, obs)
        prior_spread = float(np.asarray(state.data[:, -1:]).std(axis=2).mean())
        post_spread = float(np.asarray(analysis.data).std(axis=2).mean())
        assert post_spread < prior_spread

    def test_weight_checkpoint_roundtrip(self, state, obs, tmp_path):
        path = str(tmp_path / "weights.h5")
        direct = ETKF(inf_factor=1.1).assimilate(state, obs)
        via_ckpt = ETKF(inf_factor=1.1, weight_save_path=path).assimilate(
            state, obs
        )
        assert_states_close(direct, via_ckpt)


class TestLETKFEquivalences:
    def test_letkf_none_localization_equals_etkf(self, state, obs):
        etkf_ana = ETKF(inf_factor=1.1).assimilate(state, obs)
        letkf_ana = LETKF(localization=None, inf_factor=1.1).assimilate(
            state, obs
        )
        assert_states_close(etkf_ana, letkf_ana)

    def test_letkf_wide_gc_equals_etkf(self, state, obs):
        # radius so large every obs has weight ~1 is NOT equal (taper < 1);
        # instead use a localization whose weights are exactly one:
        class UnitLoc(GaspariCohn):
            def localize_obs(self, grid_coord, obs_coords):
                w = jnp.ones(obs_coords.shape[0])
                return w > 0, w

        loc = UnitLoc(1.0, dummy_distance)
        etkf_ana = ETKF(inf_factor=1.1).assimilate(state, obs)
        letkf_ana = LETKF(localization=loc, inf_factor=1.1).assimilate(
            state, obs
        )
        assert_states_close(etkf_ana, letkf_ana)

    def test_chunked_equals_unchunked(self, state, obs):
        loc = GaspariCohn((10.0,), dummy_distance)
        full = LETKF(localization=loc, chunksize=None).assimilate(state, obs)
        chunked = LETKF(localization=loc, chunksize=7).assimilate(state, obs)
        assert_states_close(full, chunked)

    def test_localization_changes_analysis(self, state, obs):
        loc = GaspariCohn((5.0,), dummy_distance)
        letkf_ana = LETKF(localization=loc).assimilate(state, obs)
        etkf_ana = ETKF().assimilate(state, obs)
        assert not np.allclose(
            np.asarray(letkf_ana.data), np.asarray(etkf_ana.data)
        )

    def test_manual_per_gridpoint_loop(self, rng):
        # the reference's strongest LETKF oracle: a manual per-gridpoint
        # masked solve reproduces assimilate() (test_letkf.py:106-157)
        from tpu_assim.ops.etkf import etkf_weights

        state = make_state(rng, n_time=1, n_ens=5, n_grid=12)
        obs = make_obs(rng, state)
        loc = GaspariCohn((3.0,), dummy_distance)
        analysis = LETKF(localization=loc, inf_factor=1.05).assimilate(
            state, obs
        )

        mean = np.asarray(state.data).mean(axis=2, keepdims=True)
        perts = np.asarray(state.data) - mean
        obs_vals = np.asarray(obs.observations)
        rcinv = 1 / np.sqrt(np.asarray(obs.covariance))
        ens_obs = np.asarray(state.data[0])  # identity operator on var x
        innov = (obs_vals - ens_obs.mean(axis=1)) * rcinv  # [time, obs]
        ens_perts = (ens_obs - ens_obs.mean(axis=1, keepdims=True)) * rcinv
        obs_info = np.asarray(obs.stacked_coords())
        grid_info = np.asarray(state.grid_info())
        for g in range(state.n_grid):
            use, w = loc.localize_obs(
                jnp.asarray(grid_info[g]), jnp.asarray(obs_info)
            )
            use = np.asarray(use)
            w = np.asarray(w)[use]
            sub_perts = ens_perts[0]  # [ens, obs]
            z = jnp.asarray(sub_perts[:, use] * np.sqrt(w))
            y = jnp.asarray((innov[0][use] * np.sqrt(w))[None, :])
            w_g = np.asarray(etkf_weights(z, y, 1.05))
            expected = mean[:, :, :, g] + np.einsum(
                "vtk,km->vtm", perts[:, :, :, g], w_g
            )
            np.testing.assert_allclose(
                np.asarray(analysis.data[:, :, :, g]), expected, atol=1e-9
            )


class TestKETKF:
    def test_linear_kernel_equals_etkf(self, state, obs):
        etkf_ana = ETKF(inf_factor=1.1).assimilate(state, obs)
        ketkf_ana = KETKF(kernel=LinearKernel(), inf_factor=1.1).assimilate(
            state, obs
        )
        assert_states_close(etkf_ana, ketkf_ana)

    def test_gauss_kernel_differs(self, state, obs):
        etkf_ana = ETKF().assimilate(state, obs)
        ketkf_ana = KETKF(kernel=GaussKernel(10.0)).assimilate(state, obs)
        assert not np.allclose(
            np.asarray(etkf_ana.data), np.asarray(ketkf_ana.data)
        )

    def test_lketkf_linear_equals_letkf(self, state, obs):
        loc = GaspariCohn((8.0,), dummy_distance)
        letkf_ana = LETKF(localization=loc, inf_factor=1.1).assimilate(
            state, obs
        )
        lketkf_ana = LKETKF(
            localization=loc, kernel=LinearKernel(), inf_factor=1.1
        ).assimilate(state, obs)
        assert_states_close(letkf_ana, lketkf_ana)

    def test_lketkf_chunked_equals_unchunked(self, state, obs):
        loc = GaspariCohn((8.0,), dummy_distance)
        full = LKETKF(
            localization=loc, kernel=GaussKernel(2.0), chunksize=None
        ).assimilate(state, obs)
        chunked = LKETKF(
            localization=loc, kernel=GaussKernel(2.0), chunksize=11
        ).assimilate(state, obs)
        assert_states_close(full, chunked)

    @pytest.mark.parametrize("selection", ["topk", "window"])
    @pytest.mark.parametrize("kernel_cls", [LinearKernel,
                                            lambda: GaussKernel(2.0)])
    def test_lketkf_max_obs_equals_dense(self, state, obs, selection,
                                         kernel_cls):
        """The fixed-size-neighborhood fast path equals the
        dense taper path at 1e-10 when max_obs covers every column's
        nonzero-taper obs (dot-product/distance kernels: zero-scaled ==
        dropped)."""
        loc = GaspariCohn((8.0,), dummy_distance)
        dense = LKETKF(
            localization=loc, kernel=kernel_cls(), inf_factor=1.1,
            chunksize=None,
        ).assimilate(state, obs)
        # obs sit on every integer grid coord; GC(r=8) support |dx| < 16
        # holds at most 31 obs per column — max_obs=34 exercises real
        # selection (nb < o = 40) while staying exact
        fast = LKETKF(
            localization=loc, kernel=kernel_cls(), inf_factor=1.1,
            chunksize=None, max_obs=34, selection=selection,
        ).assimilate(state, obs)
        assert_states_close(dense, fast)


@pytest.fixture
def single_obs(rng, state):
    """Observations at the analysis (last) time only — the IEnKS outer loop
    propagates a single-analysis-time state, so the identity forward model
    only aligns with single-time obs (the reference instead uses full-window
    forward models, test_ienks.py:72)."""
    obs = make_obs(rng, state)
    return obs.sel_time(float(state.times[-1]))


class TestIEnKS:
    def test_one_iter_identity_model_equals_etkf(self, state, single_obs):
        # reference: IEnKS with linear (identity) model and max_iter=1
        # equals ETKF (test_ienks.py:215-238)
        etkf_ana = ETKF(inf_factor=1.0, smoother=False).assimilate(
            state, single_obs
        )
        ienks_ana = IEnKSTransform(
            forward_model=dummy_model, tau=1.0, max_iter=1
        ).assimilate(state, single_obs)
        assert_states_close(etkf_ana, ienks_ana, atol=1e-8)

    def test_bundle_one_iter_close_to_etkf(self, state, single_obs):
        etkf_ana = ETKF(inf_factor=1.0).assimilate(state, single_obs)
        ienks_ana = IEnKSBundle(
            forward_model=dummy_model, tau=1.0, epsilon=1e-5, max_iter=1
        ).assimilate(state, single_obs)
        # bundle uses finite differences: close but not exact
        np.testing.assert_allclose(
            np.asarray(ienks_ana.data), np.asarray(etkf_ana.data), atol=1e-3
        )

    def test_more_iterations_converge(self, state, single_obs):
        a1 = IEnKSTransform(
            forward_model=dummy_model, tau=0.7, max_iter=8
        ).assimilate(state, single_obs)
        a2 = IEnKSTransform(
            forward_model=dummy_model, tau=0.7, max_iter=9
        ).assimilate(state, single_obs)
        np.testing.assert_allclose(
            np.asarray(a1.data), np.asarray(a2.data), atol=1e-4
        )

    def test_tau_bounds(self):
        with pytest.raises(ValueError):
            IEnKSTransform(forward_model=dummy_model, tau=1.5)
        with pytest.raises(ValueError):
            IEnKSTransform(forward_model=dummy_model, tau=-0.1)
        with pytest.raises(ValueError):
            IEnKSBundle(forward_model=dummy_model, epsilon=-1e-3)

    def test_localized_one_iter_equals_letkf(self, state, single_obs):
        loc = GaspariCohn((6.0,), dummy_distance)
        letkf_ana = LETKF(localization=loc, inf_factor=1.0).assimilate(
            state, single_obs
        )
        lienks_ana = LocalizedIEnKSTransform(
            forward_model=dummy_model, localization=loc, tau=1.0, max_iter=1
        ).assimilate(state, single_obs)
        assert_states_close(letkf_ana, lienks_ana, atol=1e-8)

    def test_localized_chunked_equals_unchunked(self, state, single_obs):
        loc = GaspariCohn((6.0,), dummy_distance)
        full = LocalizedIEnKSTransform(
            forward_model=dummy_model, localization=loc, max_iter=2,
            chunksize=None,
        ).assimilate(state, single_obs)
        chunked = LocalizedIEnKSTransform(
            forward_model=dummy_model, localization=loc, max_iter=2,
            chunksize=13,
        ).assimilate(state, single_obs)
        assert_states_close(full, chunked)

    def test_localized_bundle_runs(self, state, single_obs):
        loc = GaspariCohn((6.0,), dummy_distance)
        ana = LocalizedIEnKSBundle(
            forward_model=dummy_model, localization=loc, max_iter=2
        ).assimilate(state, single_obs)
        assert ana.valid

    @pytest.mark.parametrize("selection", ["topk", "window"])
    def test_localized_max_obs_equals_dense(self, state, single_obs,
                                            selection):
        """The fixed-size-neighborhood fast path equals the
        dense taper path at 1e-10 (GC(r=6) support |dx| < 12 holds at most
        23 obs; max_obs=26 < o exercises real selection)."""
        loc = GaspariCohn((6.0,), dummy_distance)
        dense = LocalizedIEnKSTransform(
            forward_model=dummy_model, localization=loc, max_iter=3,
            chunksize=None,
        ).assimilate(state, single_obs)
        fast = LocalizedIEnKSTransform(
            forward_model=dummy_model, localization=loc, max_iter=3,
            chunksize=None, max_obs=26, selection=selection,
        ).assimilate(state, single_obs)
        assert_states_close(dense, fast)

    def test_localized_bundle_max_obs_equals_dense(self, state, single_obs):
        loc = GaspariCohn((6.0,), dummy_distance)
        dense = LocalizedIEnKSBundle(
            forward_model=dummy_model, localization=loc, max_iter=2,
            chunksize=None,
        ).assimilate(state, single_obs)
        fast = LocalizedIEnKSBundle(
            forward_model=dummy_model, localization=loc, max_iter=2,
            chunksize=None, max_obs=26,
        ).assimilate(state, single_obs)
        assert_states_close(dense, fast)


class TestTransforms:
    def test_multiplicative_inflation_pre(self, state, obs):
        from tpu_assim.transform import MultiplicativeInflation

        trans = MultiplicativeInflation(inf_factor=4.0)
        inflated, _, _ = trans.pre(state, [obs])
        # perturbations doubled, mean unchanged
        np.testing.assert_allclose(
            np.asarray(inflated.data.mean(axis=2)),
            np.asarray(state.data.mean(axis=2)),
            atol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(inflated.data.std(axis=2)),
            2 * np.asarray(state.data.std(axis=2)),
            atol=1e-10,
        )

    def test_normalizer_roundtrip(self, state, obs):
        from tpu_assim.transform import Normalizer

        trans = Normalizer(
            ens_stat=(2.0, 3.0), obs_stat=[(0.0, 1.0)], fg_stat=(0.0, 1.0)
        )
        normed, obs_list, _ = trans.pre(state, [obs])
        restored = trans.post(normed, state, obs_list)
        np.testing.assert_allclose(
            np.asarray(restored.data), np.asarray(state.data), atol=1e-10
        )


class TestLETKFNeighborhoodOption:
    """LETKF(max_obs=...) through the class API equals the dense LETKF when
    the neighborhood covers every nonzero-taper obs."""

    def test_max_obs_equals_dense(self, state, obs):
        from tpu_assim.ops.localization import GaspariCohn

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((4.0,), dist)
        dense = LETKF(localization=loc, inf_factor=1.1)
        nbh = LETKF(localization=loc, inf_factor=1.1, max_obs=32)
        win = LETKF(localization=loc, inf_factor=1.1, max_obs=32,
                    selection="window")
        a_dense = dense.assimilate(state, obs)
        a_nbh = nbh.assimilate(state, obs)
        a_win = win.assimilate(state, obs)
        np.testing.assert_allclose(np.asarray(a_nbh.data),
                                   np.asarray(a_dense.data),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(np.asarray(a_win.data),
                                   np.asarray(a_dense.data),
                                   rtol=1e-10, atol=1e-10)


class TestSmoother4D:
    """4D-DA smoother mode: obs over the whole window are stacked into a flat
    obs_id = (time, obs) dim and one weight set updates the window
    (reference: interface/base.py:222-241, smoother flag base.py:61)."""

    def test_smoother_equals_hand_stacked_etkf(self, rng, state, obs):
        from tpu_assim.ops.etkf import etkf_weights

        etkf = ETKF(inf_factor=1.1, smoother=True)
        analysis = etkf.assimilate(state, obs)

        # hand computation: stack all times' normalized perts/innovations
        data = np.asarray(state.data)          # [v, t, k, g]
        obs_v = np.asarray(obs.observations)   # [t, g]
        var = np.asarray(obs.covariance)
        ens_obs = data[0]                      # identity operator on 'x'
        mean = ens_obs.mean(axis=1, keepdims=True)
        perts = (ens_obs - mean) / np.sqrt(var)          # [t, k, g]
        innov = (obs_v - mean[:, 0]) / np.sqrt(var)      # [t, g]
        k = state.ens_size
        perts_flat = np.swapaxes(perts, 0, 1).reshape(k, -1)
        innov_flat = innov.reshape(-1)
        w = etkf_weights(jnp.asarray(perts_flat),
                         jnp.asarray(innov_flat)[None, :], 1.1)
        sm = data.mean(axis=2, keepdims=True)
        expected = sm + np.einsum("vtkg,km->vtmg", data - sm, np.asarray(w))
        np.testing.assert_allclose(np.asarray(analysis.data), expected,
                                   rtol=1e-10, atol=1e-10)

    def test_filter_mode_only_updates_analysis_time(self, rng, state, obs):
        etkf = ETKF(inf_factor=1.1, smoother=False)
        analysis = etkf.assimilate(state, obs, analysis_time=1.0)
        # filtering slices to one time (reference filter.py:38-54)
        assert analysis.n_times == 1
        np.testing.assert_array_equal(np.asarray(analysis.times), [1.0])


class TestCorrelatedRInterface:
    def test_correlated_equals_explicit_whitening(self, rng, state):
        """Assimilating with a correlated R equals assimilating the
        pre-whitened problem with unit variances."""
        n_grid = state.n_grid
        a = rng.randn(n_grid, n_grid) * 0.05
        cov = a @ a.T + np.eye(n_grid)
        truth = np.asarray(state.data[0].mean(axis=1))
        obs_vals = truth + rng.randn(*truth.shape)
        obs_corr = Observation(
            jnp.asarray(obs_vals), jnp.asarray(cov),
            obs_coords=state.grid_coords, times=state.times,
            operator=dummy_obs_operator(), correlated=True,
        )
        etkf = ETKF(inf_factor=1.0)
        analysis = etkf.assimilate(state, obs_corr)
        assert analysis.valid
        # whitened problem: L^{-1} y with identity-like operator cannot be
        # expressed via the public operator API directly, so check the
        # algebra instead: innovations normalized by the Cholesky factor
        chol = np.linalg.cholesky(cov)
        idx = state.time_index(None)
        data = np.asarray(state.data)[:, idx:idx + 1]
        ens_obs = data[0]
        mean = ens_obs.mean(axis=1, keepdims=True)
        innov = obs_vals[idx:idx + 1] - mean[:, 0]
        innov_w = np.linalg.solve(chol, innov[0])
        perts_w = np.linalg.solve(chol, (ens_obs[0] - mean[0]).T).T
        from tpu_assim.ops.etkf import etkf_weights

        w = etkf_weights(jnp.asarray(perts_w), jnp.asarray(innov_w)[None, :],
                         1.0)
        sm = data.mean(axis=2, keepdims=True)
        expected = sm + np.einsum("vtkg,km->vtmg", data - sm, np.asarray(w))
        np.testing.assert_allclose(np.asarray(analysis.data), expected,
                                   rtol=1e-9, atol=1e-9)


class TestIEnKSWithRealModel:
    def test_ienks_l96_forward_model_converges(self, rng):
        """IEnKS outer loop with an RK4/Lorenz-96 forward model: the analysis
        fits the observations better than the background (the reference
        exercises the same composition, test_ienks.py with L96)."""
        from tpu_assim.models import Lorenz96, RK4Integrator

        n_grid, n_ens = 40, 25
        integ = RK4Integrator(Lorenz96(), dt=0.05)
        base = rng.randn(n_grid) + 8.0
        # biased background: the ensemble is centered away from the truth,
        # so the outer loop has an actual misfit to reduce
        bias = 1.5 * rng.randn(n_grid)
        data = np.stack([base + bias + 0.5 * rng.randn(n_grid)
                         for _ in range(n_ens)])
        state = EnsembleState(
            jnp.asarray(data)[None, None],
            times=jnp.asarray([0.0]),
        )

        def forward_model(st, iter_num):
            prop = st.replace(data=integ.integrate(st.data))
            return prop, prop

        truth = integ.integrate(jnp.asarray(base))
        obs_vals = np.asarray(truth) + 0.3 * rng.randn(n_grid)
        obs = Observation(
            jnp.asarray(obs_vals)[None, :], jnp.full((n_grid,), 0.09),
            obs_coords=jnp.arange(n_grid, dtype=jnp.float64)[:, None],
            times=jnp.asarray([0.0]),
            operator=dummy_obs_operator(),
        )
        ienks = IEnKSTransform(forward_model=forward_model, max_iter=6,
                               tau=1.0)
        analysis = ienks.assimilate(state, obs)
        # propagate analysis and background, compare obs-space fit
        prop_ana = integ.integrate(analysis.data[0, 0])
        prop_back = integ.integrate(state.data[0, 0])
        fit_ana = float(jnp.mean((jnp.mean(prop_ana, 0) - truth) ** 2))
        fit_back = float(jnp.mean((jnp.mean(prop_back, 0) - truth) ** 2))
        assert fit_ana < 0.6 * fit_back


class TestGridChunking:
    def test_map_grid_chunked_matches_unchunked(self, rng):
        from tpu_assim.interface.mixin_local import map_grid_chunked

        grid_info = jnp.asarray(rng.randn(37, 3))

        def fn(chunk):
            return chunk * 2.0 + 1.0

        full = map_grid_chunked(fn, grid_info, None)
        chunked = map_grid_chunked(fn, grid_info, 8)
        np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                                   atol=1e-12)
        assert chunked.shape == (37, 3)


class TestKernelizedNewtonSolver:
    """KETKF/LKETKF with method='newton' (matmul-only solve on the
    PSD centered kernel Gram) equals the exact eigh solve."""

    def test_ketkf_newton_equals_eigh(self, state, obs):
        a_eigh = KETKF(kernel=GaussKernel(2.0), inf_factor=1.1,
                       method="eigh").assimilate(state, obs)
        a_newt = KETKF(kernel=GaussKernel(2.0), inf_factor=1.1,
                       method="newton",
                       newton_iters=40).assimilate(state, obs)
        assert_states_close(a_eigh, a_newt, atol=1e-8)

    def test_lketkf_newton_equals_eigh(self, state, obs):
        loc = GaspariCohn((8.0,), dummy_distance)
        a_eigh = LKETKF(localization=loc, kernel=GaussKernel(2.0),
                        inf_factor=1.1, method="eigh").assimilate(state, obs)
        a_newt = LKETKF(localization=loc, kernel=GaussKernel(2.0),
                        inf_factor=1.1, method="newton",
                        newton_iters=40).assimilate(state, obs)
        assert_states_close(a_eigh, a_newt, atol=1e-8)


class TestMakeLIEnKSStep:
    """make_lienks_step (the jitted bench/production smoother entry) vs
    the class API (LocalizedIEnKSTransform/Bundle) with the identity
    forward model — same math, one XLA program."""

    @pytest.mark.parametrize("kind", ["transform", "bundle"])
    def test_matches_class_api(self, rng, kind):
        from tpu_assim.analysis import make_lienks_step

        n_ens, n_grid = 10, 40
        state = make_state(rng, n_var=1, n_time=1, n_ens=n_ens,
                           n_grid=n_grid)
        obs = make_obs(rng, state)
        loc = GaspariCohn((6.0,), dummy_distance)
        cls = (LocalizedIEnKSTransform if kind == "transform"
               else LocalizedIEnKSBundle)
        ref = cls(
            forward_model=dummy_model, localization=loc, tau=0.8,
            max_iter=3, chunksize=None, max_obs=26, selection="window",
        ).assimilate(state, obs)
        step = make_lienks_step(
            loc, None, 0, n_outer=3, kind=kind, tau=0.8, max_obs=26,
            selection="window",
        )
        out = step(
            state.data[0, 0],
            jnp.asarray(np.asarray(obs.observations)[0]),
            obs.covariance,
            jnp.arange(n_grid, dtype=jnp.int32),
            state.grid_coords,
            obs.obs_coords,
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref.data)[0, 0], atol=1e-8,
            rtol=1e-8,
        )

    def test_l96_smoother_beats_prior(self, rng):
        """With a real forward model (L96+RK4 over the window), the
        localized IEnKS analysis of the window START state propagates to
        a better fit of the window-END observations than the prior — the
        4D-Var-shaped use the reference builds by hand."""
        from tpu_assim.analysis import make_lienks_step
        from tpu_assim.models import Lorenz96, RK4Integrator
        from tpu_assim.models.integration import integrate_trajectory

        g, k, n_int = 40, 15, 4
        integ = RK4Integrator(Lorenz96(), dt=0.05)
        truth0 = jnp.asarray(rng.normal(size=g) + 8.0)
        truth0 = integrate_trajectory(integ, truth0, 200)[-1]
        truth1 = integrate_trajectory(integ, truth0, n_int)[-1]
        ens0 = truth0[None, :] + 0.8 * jnp.asarray(rng.normal(size=(k, g)))
        obs_idx = jnp.arange(0, g, 2, dtype=jnp.int32)
        obs_vals = truth1[obs_idx] + 0.3 * jnp.asarray(
            rng.normal(size=g // 2))
        obs_var = jnp.full((g // 2,), 0.09)
        grid_coords = jnp.arange(g, dtype=jnp.float64)[:, None]
        obs_coords = grid_coords[obs_idx]
        loc = GaspariCohn((4.0,), dummy_distance)
        step = make_lienks_step(loc, integ, n_int, n_outer=3, tau=0.6,
                                max_obs=18, selection="window")
        ana0 = step(ens0, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords)
        assert np.isfinite(np.asarray(ana0)).all()
        # propagate both to the obs time and compare fit
        def prop(x):
            for _ in range(n_int):
                x = integ.integrate(x)
            return x
        fit_prior = float(jnp.sqrt(jnp.mean(
            (jnp.mean(prop(ens0), 0)[obs_idx] - obs_vals) ** 2)))
        fit_post = float(jnp.sqrt(jnp.mean(
            (jnp.mean(prop(ana0), 0)[obs_idx] - obs_vals) ** 2)))
        assert fit_post < 0.7 * fit_prior, (fit_prior, fit_post)


class TestLKETKFCheb:
    """LKETKF(method='cheb'): the fused kernelized solve+apply (vector-only
    Chebyshev on the centered kernel Gram, no [g, k, k] weights, no
    eigendecomposition) equals the eigh weight path through assimilate()."""

    @pytest.mark.parametrize("kernel_cls", [LinearKernel, GaussKernel])
    @pytest.mark.parametrize("selection", ["topk", "window"])
    def test_cheb_matches_eigh(self, state, obs, kernel_cls, selection):
        loc = GaspariCohn((8.0,), dummy_distance)
        exact = LKETKF(
            localization=loc, kernel=kernel_cls(), inf_factor=1.1,
            chunksize=None, max_obs=34, selection=selection,
        ).assimilate(state, obs)
        cheb = LKETKF(
            localization=loc, kernel=kernel_cls(), inf_factor=1.1,
            chunksize=None, max_obs=34, selection=selection,
            method="cheb",
        ).assimilate(state, obs)
        np.testing.assert_allclose(
            np.asarray(cheb.data), np.asarray(exact.data),
            atol=1e-6, rtol=1e-6,
        )

    def test_cheb_dense_taper_matches_eigh(self, state, obs):
        """No max_obs: the dense-taper branch of the fused path."""
        loc = GaspariCohn((8.0,), dummy_distance)
        exact = LKETKF(localization=loc, kernel=GaussKernel(),
                       inf_factor=1.1, chunksize=None).assimilate(state, obs)
        cheb = LKETKF(localization=loc, kernel=GaussKernel(),
                      inf_factor=1.1, chunksize=None,
                      method="cheb").assimilate(state, obs)
        np.testing.assert_allclose(np.asarray(cheb.data),
                                   np.asarray(exact.data),
                                   atol=1e-6, rtol=1e-6)

    def test_cheb_chunked_equals_unchunked(self, state, obs):
        loc = GaspariCohn((8.0,), dummy_distance)
        full = LKETKF(localization=loc, kernel=GaussKernel(),
                      inf_factor=1.1, chunksize=None, max_obs=34,
                      method="cheb").assimilate(state, obs)
        chunked = LKETKF(localization=loc, kernel=GaussKernel(),
                         inf_factor=1.1, chunksize=13, max_obs=34,
                         method="cheb").assimilate(state, obs)
        np.testing.assert_allclose(np.asarray(chunked.data),
                                   np.asarray(full.data),
                                   atol=1e-10, rtol=1e-10)

    def test_cheb_rejects_weight_save(self):
        with pytest.raises(ValueError, match="materializes"):
            LKETKF(method="cheb", weight_save_path="/tmp/w.h5")

    def test_weight_request_on_cheb_instance_is_exact(self, state, obs):
        loc = GaspariCohn((8.0,), dummy_distance)
        a_cheb = LKETKF(localization=loc, kernel=GaussKernel(),
                        inf_factor=1.1, chunksize=None, method="cheb")
        a_eigh = LKETKF(localization=loc, kernel=GaussKernel(),
                        inf_factor=1.1, chunksize=None)
        sliced = state.sel_time_index(state.time_index(None))
        obs_t = obs.sel_time(float(state.times[-1]))
        eo, filt = a_cheb._apply_obs_operator(sliced, [obs_t])
        w_c = a_cheb.estimate_weights(sliced, filt, eo)
        w_e = a_eigh.estimate_weights(sliced, filt, eo)
        np.testing.assert_allclose(np.asarray(w_c), np.asarray(w_e),
                                   atol=1e-10, rtol=1e-10)

    def test_cheb_smoother_mode(self, state, obs):
        """Smoother mode: ns = n_var * n_time slices share the per-column
        kernelized Chebyshev solve; stacked multi-time obs."""
        loc = GaspariCohn((8.0,), dummy_distance)
        exact = LKETKF(localization=loc, kernel=GaussKernel(),
                       inf_factor=1.1, chunksize=None, max_obs=90,
                       smoother=True).assimilate(state, obs)
        cheb = LKETKF(localization=loc, kernel=GaussKernel(),
                      inf_factor=1.1, chunksize=None, max_obs=90,
                      smoother=True, method="cheb").assimilate(state, obs)
        assert cheb.n_times == state.n_times
        np.testing.assert_allclose(np.asarray(cheb.data),
                                   np.asarray(exact.data),
                                   atol=1e-6, rtol=1e-6)
