"""
Differentiable-DA tests (reference genre 5: weights backprop to inputs and to
``inf_factor`` as an ``nn.Parameter``, tests/unit_tests/core/test_etkf.py:
105-126; learnable NN kernel, testing/dummy.py:154 DummyNeuralModule).

In the rebuild the whole analysis is a pure jittable function, so gradients
flow end-to-end: through the eigendecomposition, the localization taper, the
kernel Gram, and the weight application.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_assim.ops.etkf import etkf_weights, letkf_weights_dense
from tpu_assim.ops.ketkf import ketkf_weights
from tpu_assim.ops.kernels import GaussKernel, ModuleKernel


@pytest.fixture
def obs_space(rng):
    perts = jnp.asarray(rng.normal(size=(10, 25)))
    perts = perts - perts.mean(axis=0, keepdims=True)
    innov = jnp.asarray(rng.normal(size=(1, 25)))
    return perts, innov


class TestGradientsThroughCores:
    def test_grad_to_inputs(self, obs_space):
        perts, innov = obs_space

        def loss(p, i):
            return jnp.sum(etkf_weights(p, i, 1.1) ** 2)

        gp, gi = jax.grad(loss, argnums=(0, 1))(perts, innov)
        assert np.isfinite(np.asarray(gp)).all()
        assert np.isfinite(np.asarray(gi)).all()
        assert float(jnp.abs(gp).max()) > 0

    def test_grad_to_inf_factor(self, obs_space):
        """The reference trains inf_factor as an nn.Parameter
        (test_etkf.py:105-126); here it is a traced scalar argument."""
        perts, innov = obs_space

        def loss(rho):
            w = etkf_weights(perts, innov, rho)
            return jnp.sum(w ** 2)

        g = jax.grad(loss)(jnp.asarray(1.1))
        assert np.isfinite(float(g)) and float(g) != 0.0

    def test_inf_factor_gradient_descent_recovers_target(self, obs_space):
        """A few gradient steps on rho reduce a weight-matching loss — the
        'learnable inflation' workflow end-to-end."""
        perts, innov = obs_space
        target = etkf_weights(perts, innov, 1.5)

        def loss(rho):
            return jnp.mean((etkf_weights(perts, innov, rho) - target) ** 2)

        rho = jnp.asarray(1.0)
        val0 = float(loss(rho))
        g_fn = jax.jit(jax.grad(loss))
        for _ in range(200):
            rho = rho - 20.0 * g_fn(rho)
        assert float(loss(rho)) < 0.05 * val0
        assert abs(float(rho) - 1.5) < 0.1

    def test_grad_through_localized_solve(self, rng, obs_space):
        perts, innov = obs_space
        obs_w = jnp.asarray(rng.uniform(size=(7, 25)))

        def loss(w_loc):
            return jnp.sum(
                letkf_weights_dense(perts, innov[0], w_loc, 1.1) ** 2
            )

        g = jax.grad(loss)(obs_w)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0

    def test_grad_through_full_analysis(self, rng):
        """d(analysis)/d(background state) through taper + solve + apply."""
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        ens, g_pts, o = 8, 32, 12
        state = jnp.asarray(rng.normal(size=(ens, g_pts)))
        obs_idx = jnp.asarray(np.arange(0, g_pts, g_pts // o)[:o],
                              dtype=jnp.int32)
        obs_vals = jnp.asarray(rng.normal(size=o))
        obs_var = jnp.full((o,), 0.5)
        grid_coords = jnp.asarray(np.arange(g_pts, dtype=float))[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        # method="newton": the matmul-only solve is smooth everywhere,
        # while eigh's VJP divides by eigenvalue gaps and NaNs on the
        # rank-deficient (degenerate-spectrum) Gram matrices localization
        # produces — torch.symeig's backward has the identical failure mode,
        # so the reference could not differentiate this case either.
        analyse = make_letkf_analysis(GaspariCohn((4.0,), dist), 1.1,
                                      method="newton")

        def loss(s):
            out = analyse(s, obs_vals, obs_var, obs_idx, grid_coords,
                          obs_coords)
            return jnp.sum(out ** 2)

        g = jax.grad(loss)(state)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0

    def test_newton_grad_matches_eigh_grad_full_rank(self, rng):
        """On a full-rank Gram (obs > ens, all weights positive) the two
        solvers' gradients agree."""
        from tpu_assim.ops.etkf import letkf_weights_dense

        perts = jnp.asarray(rng.normal(size=(6, 30)))
        innov = jnp.asarray(rng.normal(size=30))
        obs_w = jnp.asarray(rng.uniform(0.2, 1.0, size=(4, 30)))

        def loss(method):
            def inner(w_loc):
                return jnp.sum(letkf_weights_dense(
                    perts, innov, w_loc, 1.1, method=method,
                    newton_iters=40) ** 2)
            return inner

        g_eigh = jax.grad(loss("eigh"))(obs_w)
        g_newton = jax.grad(loss("newton"))(obs_w)
        np.testing.assert_allclose(np.asarray(g_newton), np.asarray(g_eigh),
                                   rtol=1e-6, atol=1e-8)


class TestLearnableKernel:
    def test_module_kernel_trains(self, rng, obs_space):
        """Gradient descent on a linear feature map inside the KETKF solve
        (the DummyNeuralModule workflow, reference testing/dummy.py:154)."""
        perts, innov = obs_space
        target = ketkf_weights(perts, innov, GaussKernel(1.5), 1.1)

        def loss(w_mat):
            kernel = ModuleKernel(lambda v: jnp.tanh(v @ w_mat))
            w = ketkf_weights(perts, innov, kernel, 1.1)
            return jnp.mean((w - target) ** 2)

        w_mat = jnp.asarray(rng.normal(size=(25, 8)) * 0.1)
        val0 = float(loss(w_mat))
        g_fn = jax.jit(jax.grad(loss))
        for _ in range(40):
            w_mat = w_mat - 0.5 * g_fn(w_mat)
        assert float(loss(w_mat)) < 0.7 * val0

    def test_grad_to_kernel_hyperparameter(self, obs_space):
        perts, innov = obs_space

        def loss(ls):
            w = ketkf_weights(perts, innov, GaussKernel(ls), 1.1)
            return jnp.sum(w ** 2)

        g = jax.grad(loss)(jnp.asarray(2.0))
        assert np.isfinite(float(g)) and float(g) != 0.0


class TestEighDegenerateSpectra:
    """The round-2 Daleckii-Krein custom JVP: method='eigh' gradients are
    NaN-free on the rank-deficient Grams localization produces and match
    the matmul-only Newton path (reference oracle:
    tests/unit_tests/core/test_etkf.py:105-126 — which torch could NOT
    differentiate in this degenerate case)."""

    def _rank_deficient(self, rng, k=10, o=30, g=4, rank=3):
        perts = jnp.asarray(rng.normal(size=(k, o)))
        innov = jnp.asarray(rng.normal(size=o))
        w = np.zeros((g, o))
        w[:, :rank] = rng.uniform(0.2, 1.0, size=(g, rank))
        return perts, innov, jnp.asarray(w)

    def test_eigh_grad_matches_newton_on_degenerate(self, rng):
        perts, innov, w = self._rank_deficient(rng)

        def loss(method):
            def f(wl, rho):
                return jnp.sum(letkf_weights_dense(
                    perts, innov, wl, rho, method=method,
                    newton_iters=50) ** 2)
            return f

        ge = jax.grad(loss("eigh"), argnums=(0, 1))(w, jnp.asarray(1.1))
        gn = jax.grad(loss("newton"), argnums=(0, 1))(w, jnp.asarray(1.1))
        for a, b in zip(ge, gn):
            assert np.isfinite(np.asarray(a)).all()
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-8, atol=1e-10)

    def test_eigh_inf_factor_grad_matches_fd(self, rng):
        perts, innov, w = self._rank_deficient(rng)

        def loss(rho):
            return jnp.sum(
                letkf_weights_dense(perts, innov, w, rho) ** 2)

        g = jax.grad(loss)(jnp.asarray(1.1))
        eps = 1e-6
        fd = (loss(jnp.asarray(1.1 + eps)) - loss(jnp.asarray(1.1 - eps))
              ) / (2 * eps)
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-6)

    def test_full_analysis_eigh_grad(self, rng):
        """The round-1 gotcha is closed: jax.grad through the default
        method='eigh' full analysis is finite."""
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        ens, g_pts, o = 8, 32, 12
        state = jnp.asarray(rng.normal(size=(ens, g_pts)))
        obs_idx = jnp.asarray(np.arange(0, g_pts, g_pts // o)[:o],
                              dtype=jnp.int32)
        obs_vals = jnp.asarray(rng.normal(size=o))
        obs_var = jnp.full((o,), 0.5)
        grid_coords = jnp.asarray(np.arange(g_pts, dtype=float))[:, None]
        obs_coords = grid_coords[obs_idx]

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        analyse = make_letkf_analysis(GaspariCohn((4.0,), dist), 1.1,
                                      method="eigh")

        def loss(s):
            return jnp.sum(analyse(s, obs_vals, obs_var, obs_idx,
                                   grid_coords, obs_coords) ** 2)

        g = jax.grad(loss)(state)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0


class TestFusedKernelVJP:
    """Gradients of the fused window paths (the GPU kernel's reverse rule
    is the plain Chebyshev twin, which runs here) — gradients match the weight-based newton path and
    finite differences at f32 accuracy."""

    def _workload(self, rng, ens=8, g_pts=48, o=16, dtype="f8"):
        state = rng.normal(size=(ens, g_pts)).astype(dtype)
        obs_idx = np.sort(rng.choice(g_pts, size=o, replace=False))
        obs_vals = rng.normal(size=o).astype(dtype)
        obs_var = np.full((o,), 0.5, dtype=dtype)
        grid_coords = np.arange(g_pts, dtype=dtype)[:, None]
        obs_coords = grid_coords[obs_idx]
        return tuple(jnp.asarray(a) for a in (
            state, obs_vals, obs_var, obs_idx.astype("i4"), grid_coords,
            obs_coords))

    @pytest.mark.parametrize("method", ["cheb", "fused1d"])
    def test_fused_grad_matches_newton(self, rng, method):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        args = self._workload(rng)

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((5.0,), dist)

        def make_loss(method):
            analyse = make_letkf_analysis(loc, 1.1, method=method,
                                          max_obs=12, cheb_degree=30,
                                          newton_iters=40)

            def loss(s):
                return jnp.sum(analyse(s, *args[1:]) ** 2)
            return loss

        g_fast = jax.grad(make_loss(method))(args[0])
        g_ref = jax.grad(make_loss("newton"))(args[0])
        assert np.isfinite(np.asarray(g_fast)).all()
        scale = float(jnp.abs(g_ref).max())
        np.testing.assert_allclose(np.asarray(g_fast) / scale,
                                   np.asarray(g_ref) / scale,
                                   atol=2e-5, rtol=0)

    def test_fused_inf_factor_grad(self, rng):
        """d(analysis)/d(rho) through the monolithic window kernel vs
        central finite differences (the learnable-inflation workflow on the
        speed-of-light path)."""
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        args = self._workload(rng)

        def dist(gc, oi):
            return jnp.abs(oi[:, 1] - gc[1])[None, :]

        loc = GaspariCohn((5.0,), dist)

        def loss(rho):
            analyse = make_letkf_analysis(loc, rho, method="fused1d",
                                          max_obs=12, cheb_degree=30)
            return jnp.sum(analyse(*args) ** 2)

        g = jax.grad(loss)(jnp.asarray(1.1))
        eps = 1e-3
        fd = (loss(jnp.asarray(1.1 + eps)) - loss(jnp.asarray(1.1 - eps))
              ) / (2 * eps)
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)

    def test_safe_sqrt(self, rng):
        from tpu_assim.ops.localization import safe_sqrt

        w = jnp.asarray([0.0, 1e-12, 0.25, 4.0])
        np.testing.assert_allclose(np.asarray(safe_sqrt(w)),
                                   np.sqrt(np.asarray(w)), atol=0)
        g = jax.grad(lambda x: jnp.sum(safe_sqrt(x)))(w)
        assert np.isfinite(np.asarray(g)).all()
        assert float(g[0]) == 0.0


class TestFused2DVJP:
    """Gradients through method='fused2d' match the weight-based newton
    path (prologue and Chebyshev solve differentiate as plain XLA)."""

    def test_fused2d_grad_matches_newton(self, rng):
        from tpu_assim.analysis import make_letkf_analysis
        from tpu_assim.ops.localization import GaspariCohn

        nr = nc = 12
        g = nr * nc
        ens, o = 8, 40
        yy, xx = np.meshgrid(np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
        grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
        state = jnp.asarray(rng.normal(size=(ens, g)))
        obs_idx = rng.choice(g, size=o, replace=False)
        args = (jnp.asarray(rng.normal(size=o)),
                jnp.asarray(rng.uniform(0.5, 1.5, size=o)),
                jnp.asarray(obs_idx.astype("i4")),
                jnp.asarray(grid_xy), jnp.asarray(grid_xy[obs_idx]))

        def dist2(gc, oi):
            return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                              jnp.abs(oi[:, 2] - gc[2])], 0)

        loc = GaspariCohn((3.5,), dist2)

        def make_loss(method):
            analyse = make_letkf_analysis(loc, 1.1, method=method,
                                          max_obs=40, cheb_degree=30,
                                          newton_iters=40)

            def loss(s):
                return jnp.sum(analyse(s, *args) ** 2)
            return loss

        g_fast = jax.grad(make_loss("fused2d"))(state)
        g_ref = jax.grad(make_loss("newton"))(state)
        assert np.isfinite(np.asarray(g_fast)).all()
        scale = float(jnp.abs(g_ref).max())
        np.testing.assert_allclose(np.asarray(g_fast) / scale,
                                   np.asarray(g_ref) / scale,
                                   atol=3e-5, rtol=0)


class TestRound5PathsDifferentiable:
    """Gradients flow through the fused kernelized Chebyshev analysis and
    through the localized IEnKS smoother (batched SVD pullback + scan
    RK4)."""

    def test_lketkf_cheb_grad_through_kernel_params(self, rng):
        import jax

        from tpu_assim.interface.lketkf import _lketkf_cheb_analysis
        from tpu_assim.ops.kernels import GaussKernel
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.testing import dummy_distance

        g, k, o = 24, 6, 16
        perts = jnp.asarray(rng.randn(k, o))
        innov = jnp.asarray(rng.randn(o))
        gi = jnp.concatenate(
            [jnp.zeros((g, 1)), jnp.arange(g, dtype=float)[:, None]], 1)
        oi = jnp.concatenate(
            [jnp.zeros((o, 1)),
             jnp.sort(jnp.asarray(rng.uniform(0, g, size=o)))[:, None]], 1)
        data = jnp.asarray(rng.randn(1, 1, k, g))
        loc = GaspariCohn((6.0,), dummy_distance)

        def loss(lengthscale, inf):
            kern = GaussKernel(lengthscale=lengthscale)
            out = _lketkf_cheb_analysis(
                loc, None, None, "topk", True, 24, kern, perts, innov,
                gi, oi, inf, data,
            )
            return jnp.sum(out ** 2)

        gl, gi_f = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(2.0), jnp.asarray(1.1))
        assert np.isfinite(float(gl)) and abs(float(gl)) > 0
        assert np.isfinite(float(gi_f)) and abs(float(gi_f)) > 0
        # finite-difference check on the lengthscale
        eps = 1e-5
        f1 = loss(jnp.asarray(2.0 + eps), jnp.asarray(1.1))
        f0 = loss(jnp.asarray(2.0 - eps), jnp.asarray(1.1))
        fd = (float(f1) - float(f0)) / (2 * eps)
        np.testing.assert_allclose(float(gl), fd, rtol=1e-4)

    def test_lienks_step_grad_through_state(self, rng):
        import jax

        from tpu_assim.analysis import make_lienks_step
        from tpu_assim.models import Lorenz96, RK4Integrator
        from tpu_assim.ops.localization import GaspariCohn
        from tpu_assim.testing import dummy_distance

        g, k, n_int = 16, 5, 2
        integ = RK4Integrator(Lorenz96(), dt=0.02)
        state = jnp.asarray(rng.normal(size=(k, g)) + 2.0)
        obs_idx = jnp.arange(0, g, 2, dtype=jnp.int32)
        obs_vals = jnp.asarray(rng.normal(size=g // 2))
        obs_var = jnp.full((g // 2,), 0.5)
        grid_coords = jnp.arange(g, dtype=float)[:, None]
        obs_coords = grid_coords[obs_idx]
        loc = GaspariCohn((4.0,), dummy_distance)
        step = make_lienks_step(loc, integ, n_int, n_outer=2, tau=0.7,
                                max_obs=12, selection="window")

        def loss(x):
            out = step(x, obs_vals, obs_var, obs_idx, grid_coords,
                       obs_coords)
            return jnp.sum(out ** 2)

        grad = jax.grad(loss)(state)
        assert np.isfinite(np.asarray(grad)).all()
        # finite-difference spot check on one entry
        eps = 1e-6
        e = jnp.zeros_like(state).at[1, 3].set(1.0)
        fd = (float(loss(state + eps * e)) - float(loss(state - eps * e))
              ) / (2 * eps)
        np.testing.assert_allclose(float(grad[1, 3]), fd, rtol=5e-4,
                                   atol=1e-6)
