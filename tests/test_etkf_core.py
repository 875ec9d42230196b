"""Tests for the ETKF analysis core.

Oracle values are the hand-computed matrices of the reference's core tests
(/root/reference/tests/unit_tests/core/test_etkf.py:142-200): a 2-member
ensemble with obs-space values (0.5, -0.5), one obs y=0.2, obs var 0.5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_assim.ops.etkf import (
    etkf_weights,
    etkf_weights_from_gram,
    etkf_prior_weights,
    letkf_weights_dense,
)
from tpu_assim.ops.linalg import evd, rev_evd, matrix_product


@pytest.fixture
def hand_case():
    obs_cinv = 1.0 / np.sqrt(0.5)
    normed_perts = jnp.asarray(np.array([[0.5], [-0.5]]) * obs_cinv)
    normed_obs = jnp.asarray(np.array([[0.2]]) * obs_cinv)
    return normed_perts, normed_obs


def test_analysed_cov(hand_case):
    # reference: test_etkf.py:142-158 expects [[.75,.25],[.25,.75]]
    perts, _ = hand_case
    evals, evects, evals_inv = evd(matrix_product(perts, perts), 1.0)
    cov = rev_evd(evals_inv, evects)
    np.testing.assert_allclose(
        np.asarray(cov), [[0.75, 0.25], [0.25, 0.75]], atol=1e-10
    )


def test_w_mean(hand_case):
    # reference: test_etkf.py:185-191 expects gain 0.5*0.2 -> [0.1, -0.1]
    perts, obs = hand_case
    w_mean, _, _ = etkf_weights_from_gram(
        matrix_product(perts, perts), matrix_product(perts, obs), 2, 1.0
    )
    np.testing.assert_allclose(
        np.asarray(w_mean).ravel(), [0.1, -0.1], atol=1e-10
    )


def test_w_perts_square_is_cov(hand_case):
    # reference: test_etkf.py:193-204
    perts, obs = hand_case
    _, w_perts, _ = etkf_weights_from_gram(
        matrix_product(perts, perts), matrix_product(perts, obs), 2, 1.0
    )
    wp = np.asarray(w_perts)
    np.testing.assert_allclose(wp @ wp.T, [[0.75, 0.25], [0.25, 0.75]],
                               atol=1e-10)


def test_weights_sum(hand_case):
    perts, obs = hand_case
    w = etkf_weights(perts, obs, 1.0)
    w_mean, w_perts, _ = etkf_weights_from_gram(
        matrix_product(perts, perts), matrix_product(perts, obs), 2, 1.0
    )
    np.testing.assert_allclose(
        np.asarray(w), np.asarray(w_mean) + np.asarray(w_perts), atol=1e-12
    )


def test_empty_obs_returns_inflated_prior():
    # reference: core/etkf.py:91-95
    perts = jnp.zeros((4, 0))
    obs = jnp.zeros((1, 0))
    w = etkf_weights(perts, obs, 1.2)
    np.testing.assert_allclose(
        np.asarray(w), np.sqrt(1.2) * np.eye(4), atol=1e-12
    )


def test_inflation_enters_as_regularizer(hand_case, rng):
    # reg = (K-1)/rho (reference: core/etkf.py:67)
    k, l = 5, 7
    perts = jnp.asarray(rng.randn(k, l))
    obs = jnp.asarray(rng.randn(1, l))
    rho = 1.3
    w = etkf_weights(perts, obs, rho)
    # manual numpy oracle
    z = np.asarray(perts)
    y = np.asarray(obs)
    g = z @ z.T
    evals, evects = np.linalg.eigh(g)
    evals = np.clip(evals, 0, None) + (k - 1) / rho
    cov = evects @ np.diag(1 / evals) @ evects.T
    w_mean = cov @ (z @ y.T)
    w_perts = evects @ np.diag(np.sqrt((k - 1) / evals)) @ evects.T
    np.testing.assert_allclose(np.asarray(w), w_mean + w_perts, atol=1e-10)


def test_1d_obs_broadcast(hand_case):
    perts, obs = hand_case
    w2d = etkf_weights(perts, obs, 1.0)
    w1d = etkf_weights(perts, obs.ravel(), 1.0)
    np.testing.assert_allclose(np.asarray(w2d), np.asarray(w1d), atol=1e-14)


def test_jit_and_grad(hand_case):
    # differentiability through the solve (reference tests backprop through
    # inf_factor and perts: test_etkf.py:121-126, 135-141)
    perts, obs = hand_case

    def loss(p, o, rho):
        return jnp.mean(etkf_weights(p, o, rho))

    g = jax.grad(loss, argnums=(0, 2))(perts, obs, 1.0)
    assert np.all(np.isfinite(np.asarray(g[0])))
    assert np.isfinite(float(g[1]))
    w_jit = jax.jit(etkf_weights)(perts, obs, 1.0)
    np.testing.assert_allclose(
        np.asarray(w_jit), np.asarray(etkf_weights(perts, obs, 1.0)),
        atol=1e-12,
    )


class TestLETKFDense:
    def test_unit_weights_equal_etkf(self, rng):
        # zero-padding equivalence: all-ones localization == global ETKF
        k, l, g = 6, 9, 4
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        w_etkf = etkf_weights(perts, obs[None, :], 1.1)
        w_letkf = letkf_weights_dense(perts, obs, jnp.ones((g, l)), 1.1)
        for i in range(g):
            np.testing.assert_allclose(
                np.asarray(w_letkf[i]), np.asarray(w_etkf), atol=1e-10
            )

    def test_masked_equals_subset(self, rng):
        # zero-weight obs are exactly equivalent to removing them
        # (reference ragged path: interface/wrapper.py:86-99)
        k, l = 5, 8
        perts = rng.randn(k, l)
        obs = rng.randn(l)
        weights = rng.rand(l)
        weights[[1, 4, 6]] = 0.0
        keep = weights > 0
        # dense masked solve
        w_dense = letkf_weights_dense(
            jnp.asarray(perts), jnp.asarray(obs),
            jnp.asarray(weights)[None, :], 1.0,
        )[0]
        # explicit subset solve with sqrt-scaling (the reference's way)
        sw = np.sqrt(weights[keep])
        sub_perts = jnp.asarray(perts[:, keep] * sw)
        sub_obs = jnp.asarray((obs[keep] * sw)[None, :])
        w_sub = etkf_weights(sub_perts, sub_obs, 1.0)
        np.testing.assert_allclose(np.asarray(w_dense), np.asarray(w_sub),
                                   atol=1e-10)

    def test_all_zero_weights_give_prior(self):
        k, l = 4, 6
        perts = jnp.asarray(np.random.RandomState(0).randn(k, l))
        obs = jnp.zeros(l)
        w = letkf_weights_dense(perts, obs, jnp.zeros((2, l)), 1.1)
        np.testing.assert_allclose(
            np.asarray(w[0]), np.sqrt(1.1) * np.eye(k), atol=1e-12
        )

    def test_batched_shape(self, rng):
        k, l, g = 3, 5, 11
        w = letkf_weights_dense(
            jnp.asarray(rng.randn(k, l)),
            jnp.asarray(rng.randn(l)),
            jnp.asarray(rng.rand(g, l)),
            1.0,
        )
        assert w.shape == (g, k, k)


class TestNewtonSolver:
    """The matmul-only Newton-Schulz path must match the eigh path
    (both compute (Z Z^T + reg I)^{-1} and its principal square root)."""

    def test_from_gram_newton_matches_eigh(self, rng):
        k, l = 12, 30
        perts = jnp.asarray(rng.randn(k, l) / np.sqrt(l))
        obs = jnp.asarray(rng.randn(1, l) / np.sqrt(l))
        gram = matrix_product(perts, perts)
        kobs = matrix_product(perts, obs)
        out_e = etkf_weights_from_gram(gram, kobs, k, 1.1, method="eigh")
        out_n = etkf_weights_from_gram(gram, kobs, k, 1.1, method="newton")
        for a, b in zip(out_e, out_n):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2e-5)

    def test_letkf_dense_newton_matches_eigh(self, rng):
        k, l, g = 8, 16, 5
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        weights = jnp.asarray(rng.rand(g, l))
        w_e = letkf_weights_dense(perts, obs, weights, 1.1, method="eigh")
        w_n = letkf_weights_dense(perts, obs, weights, 1.1, method="newton",
                                  newton_iters=40)
        np.testing.assert_allclose(np.asarray(w_e), np.asarray(w_n),
                                   atol=2e-4)


class TestNeighborhoodLETKF:
    """Fixed-size top-k obs neighborhoods must reproduce the dense masked
    solve exactly whenever max_obs covers every nonzero-weight obs
    (zero-weight padding contributes nothing to the Gram products)."""

    def test_nbh_equals_dense(self, rng):
        from tpu_assim.ops.etkf import letkf_weights_nbh
        from tpu_assim.ops.localization import (
            GaspariCohn, neighborhood_select,
        )

        k, l, g = 6, 30, 12
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        grid_coords = jnp.asarray(
            np.stack([np.zeros(g), np.arange(g, dtype=float) * 2.5], axis=1)
        )
        obs_coords = jnp.asarray(
            np.stack([np.zeros(l), np.linspace(0, 30, l)], axis=1)
        )

        def dist_fn(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((3.0,), dist_fn)
        w_dense_loc = loc.taper_weights(grid_coords, obs_coords)
        max_nonzero = int(np.max(np.sum(np.asarray(w_dense_loc) > 0, axis=1)))
        nb = max_nonzero + 2  # covers every nonzero obs -> exact
        idx, wn = neighborhood_select(loc, grid_coords, obs_coords, nb)
        w_dense = letkf_weights_dense(perts, obs, w_dense_loc, 1.1)
        w_nbh = letkf_weights_nbh(perts, obs, idx, wn, 1.1)
        np.testing.assert_allclose(np.asarray(w_nbh), np.asarray(w_dense),
                                   atol=1e-10)

    def test_nbh_pads_when_fewer_obs_than_max(self, rng):
        from tpu_assim.ops.etkf import letkf_weights_nbh
        from tpu_assim.ops.localization import (
            GaspariCohn, neighborhood_select,
        )

        k, l, g = 4, 5, 3
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        grid_coords = jnp.asarray(np.zeros((g, 2)))
        obs_coords = jnp.asarray(
            np.stack([np.zeros(l), np.arange(l, dtype=float)], axis=1)
        )

        def dist_fn(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((10.0,), dist_fn)
        idx, wn = neighborhood_select(loc, grid_coords, obs_coords, 8)
        assert idx.shape == (g, 8) and wn.shape == (g, 8)
        assert np.all(np.asarray(wn[:, l:]) == 0.0)
        w = letkf_weights_nbh(perts, obs, idx, wn, 1.0)
        assert np.isfinite(np.asarray(w)).all()

    def test_analysis_nbh_matches_dense(self, rng):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        k, g, o = 8, 64, 16
        state = jnp.asarray(rng.randn(k, g))
        obs_locs = np.linspace(0, g, num=o, endpoint=False)
        obs_idx = jnp.asarray(np.rint(obs_locs).astype(np.int32) % g)
        obs_vals = jnp.asarray(rng.randn(o))
        obs_var = jnp.asarray(np.full(o, 0.5))
        gcoords = jnp.asarray(np.arange(g, dtype=float)[:, None])
        ocoords = jnp.asarray(obs_locs[:, None])

        def dist_fn(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((6.0,), dist_fn)
        dense = make_letkf_analysis(loc, inf_factor=1.1)
        nbh = make_letkf_analysis(loc, inf_factor=1.1, max_obs=8)
        a_dense = dense(state, obs_vals, obs_var, obs_idx, gcoords, ocoords)
        a_nbh = nbh(state, obs_vals, obs_var, obs_idx, gcoords, ocoords)
        np.testing.assert_allclose(np.asarray(a_nbh), np.asarray(a_dense),
                                   atol=1e-9)


class TestWoodburySolver:
    """Dual-space solve must equal the eigh path (same weights at working
    precision), including zero-weight padded neighborhoods."""

    def test_woodbury_matches_eigh(self, rng):
        from tpu_assim.ops.etkf import letkf_weights_nbh

        k, l, g, nb = 10, 40, 7, 6
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        idx = jnp.asarray(rng.randint(0, l, size=(g, nb)).astype(np.int32))
        w = jnp.asarray(rng.rand(g, nb))
        w_e = letkf_weights_nbh(perts, obs, idx, w, 1.1, method="eigh")
        w_w = letkf_weights_nbh(perts, obs, idx, w, 1.1, method="woodbury",
                                newton_iters=20)
        np.testing.assert_allclose(np.asarray(w_w), np.asarray(w_e),
                                   atol=1e-9)

    def test_woodbury_zero_padded(self, rng):
        from tpu_assim.ops.etkf import letkf_weights_nbh

        k, l, g, nb = 8, 30, 5, 6
        perts = jnp.asarray(rng.randn(k, l))
        obs = jnp.asarray(rng.randn(l))
        idx = jnp.asarray(rng.randint(0, l, size=(g, nb)).astype(np.int32))
        w = jnp.asarray(rng.rand(g, nb)).at[:, 3:].set(0.0)
        w_e = letkf_weights_nbh(perts, obs, idx, w, 1.0, method="eigh")
        w_w = letkf_weights_nbh(perts, obs, idx, w, 1.0, method="woodbury",
                                newton_iters=20)
        np.testing.assert_allclose(np.asarray(w_w), np.asarray(w_e),
                                   atol=1e-9)


class TestChebSolve:
    """The Chebyshev/Clenshaw solve over gathered neighbourhoods must
    reproduce the weights-then-apply reference composition."""

    def _reference(self, perts, obs, idx, w, state, inf):
        from tpu_assim.ops.etkf import letkf_weights_nbh

        wmat = letkf_weights_nbh(
            jnp.asarray(perts), jnp.asarray(obs), jnp.asarray(idx),
            jnp.asarray(w), inf, method="eigh",
        )
        mean = state.mean(0)
        sp = state - mean
        return mean + np.einsum("kg,gkm->mg", sp, np.asarray(wmat))

    def test_cheb_matches_reference(self, rng):
        from tpu_assim.ops.window import letkf_nbh_analysis_cheb

        k, l, g, nb, inf = 12, 50, 37, 8, 1.1
        perts = rng.randn(k, l).astype("f4")
        obs = rng.randn(l).astype("f4")
        idx = rng.randint(0, l, size=(g, nb)).astype("i4")
        w = rng.rand(g, nb).astype("f4")
        w[:, 6:] = 0.0
        state = rng.randn(k, g).astype("f4")
        ref = self._reference(perts, obs, idx, w, state, inf)
        sw = np.sqrt(w)
        zh = np.transpose(perts[:, idx], (2, 0, 1)) * sw.T[:, None, :]
        yh = obs[idx].T * sw.T
        mean = state.mean(0)
        sp = state - mean
        reg = jnp.asarray((k - 1) / inf, jnp.float32)
        out = letkf_nbh_analysis_cheb(
            jnp.asarray(zh), jnp.asarray(yh), jnp.asarray(sp),
            jnp.asarray(mean), reg, k, degree=14,
        )
        np.testing.assert_allclose(np.asarray(out), ref, atol=2e-4)

    def test_all_zero_weights_gives_inflated_prior(self, rng):
        """Empty-neighborhood columns degenerate to sqrt(rho)-inflated
        perturbations about the unchanged mean (reference empty-obs path,
        core/etkf.py:91-95) — exactly, despite the Chebyshev interval
        floor."""
        from tpu_assim.ops.window import letkf_nbh_analysis_cheb

        k, g, nb, inf = 8, 9, 5, 1.21
        zh = np.zeros((nb, k, g), dtype="f4")
        yh = np.zeros((nb, g), dtype="f4")
        state = rng.randn(k, g).astype("f4")
        mean = state.mean(0)
        sp = state - mean
        reg = jnp.asarray((k - 1) / inf, jnp.float32)
        out = letkf_nbh_analysis_cheb(
            jnp.asarray(zh), jnp.asarray(yh), jnp.asarray(sp),
            jnp.asarray(mean), reg, k, degree=10,
        )
        np.testing.assert_allclose(
            np.asarray(out), mean + np.sqrt(inf) * sp, rtol=1e-5, atol=1e-6
        )


class TestWindowSelection:
    """Sorted-coordinate window neighborhoods == top-k neighborhoods for 1-D
    monotone layouts (ops/localization.py:neighborhood_select_window)."""

    def test_window_equals_topk_weights(self, rng):
        from tpu_assim.ops.localization import (
            GaspariCohn,
            neighborhood_select,
            neighborhood_select_window,
        )

        g, o, radius, nb = 200, 50, 6.0, 12
        grid_x = np.arange(g, dtype=np.float64)
        obs_x = np.sort(rng.uniform(0, g, size=o))

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((radius,), dist)
        gi = jnp.asarray(np.stack([np.zeros(g), grid_x], 1))
        oi = jnp.asarray(np.stack([np.zeros(o), obs_x], 1))
        idx_t, w_t = neighborhood_select(loc, gi, oi, nb)
        idx_w, w_w = neighborhood_select_window(loc, gi, oi, nb)
        # same *sets* of (index, weight) pairs per column wherever weights
        # are nonzero (orderings differ: top-k sorts by weight, window by
        # coordinate)
        for c in range(0, g, 17):
            top = {(int(i), round(float(w), 10))
                   for i, w in zip(idx_t[c], w_t[c]) if w > 0}
            win = {(int(i), round(float(w), 10))
                   for i, w in zip(idx_w[c], w_w[c]) if w > 0}
            assert top == win

    def test_window_analysis_equals_topk_analysis(self, rng):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        ens, g, o = 8, 96, 24
        state = rng.normal(size=(ens, g))
        obs_idx = np.sort(rng.choice(g, size=o, replace=False))
        obs_vals = rng.normal(size=o)
        obs_var = rng.uniform(0.5, 1.5, size=o)
        grid_coords = np.arange(g, dtype=np.float64)[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((5.0,), dist)
        args = tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords))
        a_topk = make_letkf_analysis(loc, 1.1, max_obs=16,
                                     selection="topk")(*args)
        a_win = make_letkf_analysis(loc, 1.1, max_obs=16,
                                    selection="window")(*args)
        np.testing.assert_allclose(np.asarray(a_win), np.asarray(a_topk),
                                   rtol=1e-10, atol=1e-10)


class TestMonolithicWindowKernel:
    """The 1-D window analysis (selection + taper + gather + solve + apply)
    vs the exact eigh analysis."""

    def test_matches_eigh_analysis(self, rng):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        ens, g, o, radius = 12, 300, 48, 8.0
        state = rng.randn(ens, g).astype("f4")
        obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype("i4")
        obs_vals = rng.randn(o).astype("f4")
        obs_var = rng.uniform(0.5, 1.5, size=o).astype("f4")
        grid_coords = np.arange(g, dtype="f4")[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((radius,), dist)
        args = tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords))
        exact = make_letkf_analysis(loc, 1.1, method="eigh")(*args)
        fused = make_letkf_analysis(
            loc, 1.1, method="fused1d", max_obs=16
        )(*args)
        rel = float(np.abs(np.asarray(fused) - np.asarray(exact)).max()
                    / np.abs(np.asarray(exact)).max())
        assert rel < 5e-5, rel

    def test_empty_window_columns_get_inflated_prior(self, rng):
        """Columns far from every obs degenerate to the inflated prior."""
        import tpu_assim.ops.window as pk

        ens, g, o = 6, 40, 4
        state = rng.randn(ens, g).astype("f4")
        perts = rng.randn(ens, o).astype("f4")
        innov = rng.randn(o).astype("f4")
        obs_x = np.array([0.0, 1.0, 2.0, 3.0], dtype="f4")
        grid_x = np.arange(100.0, 140.0, dtype="f4")  # all far away
        m = state.mean(0)
        sp = state - m
        inf = 1.21
        reg = jnp.asarray((ens - 1) / inf, jnp.float32)
        out = pk.letkf_window_analysis_fused(
            jnp.asarray(perts), jnp.asarray(innov), jnp.asarray(obs_x),
            jnp.asarray(grid_x), jnp.asarray(sp), jnp.asarray(m), reg,
            2.0, ens, nb=4, degree=10,
        )
        np.testing.assert_allclose(
            np.asarray(out), m + np.sqrt(inf) * sp, rtol=1e-5, atol=1e-6
        )
