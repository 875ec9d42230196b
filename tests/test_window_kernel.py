"""The 1-D window analysis: its GPU kernel (through the Pallas interpreter)
and its plain XLA twin against a float64 per-column oracle, the exactness
guards, the kernel's reverse rule, its block shapes, and where the kernel
is chosen (tpu_assim.device.kernel_or_plain)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_assim.ops import window
from tpu_assim.ops.window_kernel import block_shape, window_analysis_kernel

RADIUS = 6.0


def _workload(seed, k=6, g=96, o=40, ns=1):
    rs = np.random.RandomState(seed)
    obs_x = np.sort(rs.uniform(0, g, o))
    return dict(
        perts=rs.randn(k, o), innov=rs.randn(o), obs_x=obs_x,
        grid_x=np.arange(g, dtype=np.float64), sp=rs.randn(ns, k, g),
        mean=rs.randn(ns, g), reg=(k - 1) / 1.1,
    )


def _oracle(w, taper):
    """f64 per-column analysis over every in-support observation."""
    f64 = np.float64
    k = w["perts"].shape[0]
    z = np.abs(w["grid_x"][:, None] - w["obs_x"][None, :]) / RADIUS
    with jax.default_device(jax.devices("cpu")[0]):
        weights = np.asarray(window._taper_poly(jnp.asarray(z, f64), taper,
                                                1e-5))
    out = np.empty(w["sp"].shape)
    for c in range(w["grid_x"].shape[0]):
        use = weights[c] > 0
        sw = np.sqrt(weights[c, use])
        zc = w["perts"][:, use] * sw
        yc = w["innov"][use] * sw
        evals, evects = np.linalg.eigh(zc @ zc.T)
        evals = np.clip(evals, 0, None) + w["reg"]
        cov = (evects / evals) @ evects.T
        w_mean = cov @ (zc @ yc)
        w_perts = (evects * np.sqrt((k - 1) / evals)) @ evects.T
        for i in range(w["sp"].shape[0]):
            out[i, :, c] = (w["mean"][i, c]
                            + w["sp"][i, :, c] @ (w_mean[:, None] + w_perts))
    return out


def _run(w, nb, taper, interpret, strict=True):
    f32 = jnp.float32
    return np.asarray(window.letkf_window_analysis_fused(
        jnp.asarray(w["perts"], f32), jnp.asarray(w["innov"], f32),
        jnp.asarray(w["obs_x"], f32), jnp.asarray(w["grid_x"], f32),
        jnp.asarray(w["sp"], f32), jnp.asarray(w["mean"], f32),
        jnp.asarray(w["reg"], f32), RADIUS, w["sp"].shape[1], nb=nb,
        degree=24, taper=taper, strict=strict, interpret=interpret))


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("g", [96, 100])
@pytest.mark.parametrize("extra_nb", [0, 5])
@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_window_analysis_matches_f64_oracle(route, ns, g, extra_nb, taper):
    """Padded (g=100) and unpadded (g=96, whole blocks) grids, a window at
    the exact in-support maximum and a wider one, one and three stacked
    state slices, both tapers — kernel and plain twin agree with the f64
    oracle to the f32 floor."""
    w = _workload(ns + g + extra_nb, g=g, ns=ns)
    nb = window.max_in_support_1d(w["obs_x"], w["grid_x"], RADIUS,
                                  taper=taper) + extra_nb
    out = _run(w, nb, taper, interpret=route == "kernel")
    ref = _oracle(w, taper)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 2e-5, err


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("guard", ["overflow", "unsorted"])
def test_exactness_guards_poison(route, guard):
    """Columns with more in-support obs than ``nb`` are NaN (strict), and
    unsorted coordinates poison everything — on both routes."""
    w = _workload(7, o=60)
    nb = window.max_in_support_1d(w["obs_x"], w["grid_x"], RADIUS)
    if guard == "unsorted":
        w["obs_x"] = w["obs_x"][::-1].copy()
        out = _run(w, nb, "gc2", interpret=route == "kernel")
        assert np.isnan(out).all()
        return
    out = _run(w, nb - 2, "gc2", interpret=route == "kernel")
    counts = np.array([window.max_in_support_1d(w["obs_x"], w["grid_x"][c:c + 1],
                                                RADIUS)
                       for c in range(w["grid_x"].shape[0])])
    over = counts > nb - 2
    assert over.any()
    assert np.isnan(out[..., over]).all()
    assert np.isfinite(out[..., ~over]).all()


@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_kernel_gradient_is_plain_twin_gradient(taper):
    """The kernel's reverse rule is jax.grad of the plain twin, in every
    array input (coordinates included through the taper)."""
    w = _workload(11, g=64, ns=2)
    nb = window.max_in_support_1d(w["obs_x"], w["grid_x"], RADIUS,
                                  taper=taper)
    args = [jnp.asarray(w[key], jnp.float32)
            for key in ("perts", "innov", "obs_x", "grid_x", "sp", "mean",
                        "reg")]
    cot = jnp.asarray(np.random.RandomState(3).randn(2, 6, 64), jnp.float32)

    def loss(interpret, *a):
        out = window.letkf_window_analysis_fused(
            *a, RADIUS, 6, nb=nb, degree=16, taper=taper,
            interpret=interpret)
        return jnp.sum(out * cot)

    argnums = tuple(range(1, 8))
    g_kernel = jax.grad(loss, argnums)(True, *args)
    g_plain = jax.grad(loss, argnums)(False, *args)
    for a, b in zip(g_kernel, g_plain):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nb, expect", [(8, (8, 128)), (12, (16, 32)),
                                        (16, (16, 32)), (40, (64, 16)),
                                        (1, (2, 256))])
def test_block_shape(nb, expect):
    """Power-of-two window pad; columns per block sized so the Gram tile
    holds 8192 floats, within [16, 256]."""
    assert block_shape(nb) == expect


def test_cpu_takes_the_plain_twin():
    """On the CPU the kernel is never lowered: the jitted program holds no
    Pallas call, only the plain twin."""
    w = _workload(5)
    f32 = jnp.float32
    hlo = jax.jit(lambda *a: window.letkf_window_analysis_fused(
        *a, RADIUS, 6, nb=12, degree=8)).lower(
        *(jnp.asarray(w[key], f32) for key in
          ("perts", "innov", "obs_x", "grid_x", "sp", "mean", "reg"))
    ).as_text()
    assert "triton" not in hlo.lower() and "pallas" not in hlo.lower()


def test_unknown_platform_raises():
    """Lowering the window analysis for a platform that has neither the
    kernel nor a plain branch raises instead of running anything
    silently."""
    w = _workload(5)
    f32 = jnp.float32
    fn = jax.jit(lambda *a: window.letkf_window_analysis_fused(
        *a, RADIUS, 6, nb=12, degree=8))
    args = [jnp.asarray(w[key], f32) for key in
            ("perts", "innov", "obs_x", "grid_x", "sp", "mean", "reg")]
    with pytest.raises(NotImplementedError, match="rocm"):
        jax.export.export(fn, platforms=["rocm"])(*args)
    jax.export.export(fn, platforms=["cpu"])(*args)  # the plain branch


def test_interpret_only_when_asked(monkeypatch):
    """``interpret=True`` runs the kernel through the interpreter; the
    default never does."""
    from tpu_assim import device

    calls = []

    def kernel(x, interpret=False):
        calls.append(interpret)
        return x + 1.0

    out = device.kernel_or_plain(kernel, lambda x: x - 1.0, jnp.ones(3),
                                 interpret=True)
    assert calls == [True] and float(out[0]) == 2.0
    out = jax.jit(lambda x: device.kernel_or_plain(
        kernel, lambda y: y - 1.0, x))(jnp.ones(3))
    assert float(out[0]) == 0.0          # CPU: the plain twin
    assert all(c is False for c in calls[1:])


def test_kernel_entry_point_shapes():
    """The kernel's own entry point pads the grid to whole blocks and
    returns exactly [ns, k, g]."""
    w = _workload(9, g=70, ns=2)
    nb = window.max_in_support_1d(w["obs_x"], w["grid_x"], RADIUS)
    start, poison = window._window_starts(
        jnp.asarray(w["obs_x"], jnp.float32),
        jnp.asarray(w["grid_x"], jnp.float32), RADIUS, nb=nb,
        epsilon=1e-5, taper="gc2", strict=True)
    out = window_analysis_kernel(
        jnp.asarray(w["perts"], jnp.float32),
        jnp.asarray(w["innov"], jnp.float32),
        jnp.asarray(w["obs_x"], jnp.float32),
        jnp.asarray(w["grid_x"], jnp.float32), start, poison,
        jnp.asarray(w["sp"], jnp.float32),
        jnp.asarray(w["mean"], jnp.float32), w["reg"], RADIUS,
        ens_size=6, nb=nb, degree=8, epsilon=1e-5, taper="gc2",
        interpret=True)
    assert out.shape == (2, 6, 70)
    assert np.isfinite(np.asarray(out)).all()
