"""Tests for tpu_assim.ops.linalg (reference oracle:
/root/reference/pytassim/core/utils.py and tests/unit_tests/core/test_utils)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_assim.ops.linalg import (
    evd,
    rev_evd,
    svd,
    rev_svd,
    matrix_product,
    diagonal_add,
    inv_sqrt_psd_newton,
)


def random_spd(rng, n, batch=()):
    a = rng.randn(*batch, n, n)
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n)


def test_evd_roundtrip(rng):
    mat = random_spd(rng, 6)
    evals, evects, evals_inv = evd(jnp.asarray(mat), 0.0)
    recomposed = rev_evd(evals, evects)
    np.testing.assert_allclose(np.asarray(recomposed), mat, atol=1e-10)
    np.testing.assert_allclose(np.asarray(evals_inv), 1 / np.asarray(evals))


def test_evd_regularization(rng):
    mat = random_spd(rng, 5)
    reg = 2.5
    evals_noreg, _, _ = evd(jnp.asarray(mat), 0.0)
    evals_reg, _, _ = evd(jnp.asarray(mat), reg)
    np.testing.assert_allclose(
        np.asarray(evals_reg), np.asarray(evals_noreg) + reg, atol=1e-10
    )


def test_evd_clamps_negative_eigenvalues(rng):
    # nearest-PSD semantics: negative eigenvalues clamp to zero before reg
    # (reference: core/utils.py:58)
    mat = np.diag([1.0, -2.0, 3.0])
    evals, _, _ = evd(jnp.asarray(mat), 0.0)
    assert np.all(np.asarray(evals) >= 0)


def test_evd_batched(rng):
    mats = random_spd(rng, 4, batch=(7,))
    evals, evects, _ = evd(jnp.asarray(mats), 1.0)
    rec = rev_evd(evals - 1.0, evects)
    np.testing.assert_allclose(np.asarray(rec), mats, atol=1e-9)


def test_svd_roundtrip(rng):
    mat = rng.randn(5, 5)
    u, s, v = svd(jnp.asarray(mat))
    rec = rev_svd(u, s, v)
    np.testing.assert_allclose(np.asarray(rec), mat, atol=1e-10)


def test_svd_regularization(rng):
    mat = rng.randn(4, 4)
    _, s0, _ = svd(jnp.asarray(mat), 0.0)
    _, s1, _ = svd(jnp.asarray(mat), 0.7)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s0) + 0.7, atol=1e-12)


def test_matrix_product(rng):
    x = rng.randn(3, 5)
    y = rng.randn(4, 5)
    out = matrix_product(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(out), x @ y.T, atol=1e-12)


def test_matrix_product_batched(rng):
    x = rng.randn(6, 3, 5)
    y = rng.randn(6, 4, 5)
    out = matrix_product(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(out), x @ np.swapaxes(y, -1, -2),
                               atol=1e-12)


def test_diagonal_add(rng):
    mat = rng.randn(4, 4)
    out = diagonal_add(jnp.asarray(mat), 3.0)
    np.testing.assert_allclose(np.asarray(out), mat + 3.0 * np.eye(4),
                               atol=1e-12)


def test_inv_sqrt_newton_matches_eigh(rng):
    mats = random_spd(rng, 8, batch=(5,))
    a_inv, a_inv_sqrt = inv_sqrt_psd_newton(jnp.asarray(mats), num_iters=20)
    ref_inv = np.linalg.inv(mats)
    np.testing.assert_allclose(np.asarray(a_inv), ref_inv, atol=1e-8)
    # a_inv_sqrt @ a_inv_sqrt == a_inv
    sq = np.asarray(a_inv_sqrt) @ np.asarray(a_inv_sqrt)
    np.testing.assert_allclose(sq, ref_inv, atol=1e-8)


def _spectrum_case(rng, kind, k, batch):
    """Symmetric PSD test matrices of the three shapes the analyses feed
    eigh: full rank, rank deficient (a localized Gram of few obs) and a
    degenerate cluster."""
    if kind == "spd":
        z = rng.randn(*batch, k, k)
        return np.einsum("...ki,...mi->...km", z, z) / k + 0.5 * np.eye(k)
    if kind == "rank_deficient":
        z = rng.randn(*batch, k, 3)
        return np.einsum("...ki,...mi->...km", z, z)
    q = np.linalg.qr(rng.randn(*batch, k, k))[0]
    evals = np.concatenate([np.full(k - 4, 2.5), np.linspace(0.1, 9.0, 4)])
    return np.einsum("...ik,k,...jk->...ij", q, evals, q)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["spd", "rank_deficient", "degenerate"])
@pytest.mark.parametrize("k", [8, 40, 100])
def test_eigh_psd_matches_numpy_f64(rng, k, kind, dtype):
    """eigh_psd against f64 numpy.linalg.eigh at the ensemble sizes the
    benchmark uses, with two leading batch dims. Eigenvector signs and the
    basis inside a degenerate cluster are arbitrary, so vectors are checked
    through recomposition and orthogonality."""
    from tpu_assim.ops.linalg import eigh_psd

    a = _spectrum_case(rng, kind, k, (2, 3))
    ev, evec = eigh_psd(jnp.asarray(a.astype(dtype)))
    tol = 2e-5 if dtype == "float32" else 1e-10
    scale = np.abs(a).max()
    ref_ev = np.linalg.eigh(a)[0]
    np.testing.assert_allclose(np.asarray(ev, np.float64), ref_ev,
                               atol=tol * scale * np.sqrt(k))
    ev64 = np.asarray(ev, np.float64)
    vec64 = np.asarray(evec, np.float64)
    rec = np.einsum("...ik,...k,...jk->...ij", vec64, ev64, vec64)
    np.testing.assert_allclose(rec, a, atol=tol * scale * np.sqrt(k))
    orth = np.einsum("...ki,...kj->...ij", vec64, vec64)
    np.testing.assert_allclose(orth, np.broadcast_to(np.eye(k), orth.shape),
                               atol=tol * np.sqrt(k))


@pytest.mark.parametrize("batch", [(65536,), (65537,), (3, 65536)],
                         ids=["one_call", "two_chunks_padded", "four_chunks"])
def test_eigh_psd_chunks_large_batches(rng, batch):
    """Past EIGH_MAX_ROWS rows eigh_psd splits the batch; each matrix's
    factors are those of one unsplit call (8 x 8: 65536 matrices are the
    limit exactly)."""
    import jax
    from tpu_assim.ops.linalg import EIGH_MAX_ROWS, eigh_psd

    assert EIGH_MAX_ROWS == 65536 * 8
    a = jnp.asarray(_spectrum_case(rng, "spd", 8, batch).astype("float32"))
    ev, evec = jax.jit(eigh_psd)(a)
    ref_ev, ref_evec = jax.jit(jnp.linalg.eigh)(a)
    assert ev.shape == batch + (8,) and evec.shape == batch + (8, 8)
    np.testing.assert_array_equal(np.asarray(ev), np.asarray(ref_ev))
    np.testing.assert_array_equal(np.asarray(evec), np.asarray(ref_evec))


def test_eigh_psd_chunks_keep_batch_sharding(rng):
    """A batch sharded over the 8 devices in contiguous blocks runs its
    chunks without moving a matrix between devices."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tpu_assim.ops.linalg import eigh_psd

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("grid",))
    sharding = NamedSharding(mesh, P("grid"))
    a = jax.device_put(
        jnp.asarray(_spectrum_case(rng, "spd", 8, (3 * 65536,)), "float32"),
        sharding)
    fn = jax.jit(eigh_psd, out_shardings=(sharding, sharding))
    hlo = fn.lower(a).compile().as_text()
    for op in ("all-gather", "all-to-all", "collective-permute",
               "all-reduce"):
        assert op not in hlo, op
    ev = fn(a)[0]
    np.testing.assert_array_equal(np.asarray(ev),
                                  np.asarray(jnp.linalg.eigh(a)[0]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [8, 40, 100])
def test_svd_matches_numpy_f64(rng, k, dtype):
    """svd (torch convention: ``v`` not ``v^T``) against f64 numpy on square
    batches with two leading batch dims — the IEnKS inner step's shape."""
    a = rng.randn(2, 3, k, k)
    u, s, v = svd(jnp.asarray(a.astype(dtype)))
    assert u.shape == v.shape == (2, 3, k, k) and s.shape == (2, 3, k)
    tol = 2e-5 if dtype == "float32" else 1e-10
    ref_s = np.linalg.svd(a, compute_uv=False)
    scale = ref_s.max()
    np.testing.assert_allclose(np.asarray(s, np.float64), ref_s,
                               atol=tol * scale * np.sqrt(k))
    rec = np.asarray(rev_svd(u, s, v), np.float64)
    np.testing.assert_allclose(rec, a, atol=tol * scale * np.sqrt(k))


def test_svd_grad_of_invariant_composition(rng):
    """Gradients through svd of a sign-invariant composition (the way the
    IEnKS steps consume the factors) match finite differences."""
    import jax

    k = 6
    a = jnp.asarray(rng.randn(2, k, k) + 3.0 * np.eye(k))
    c = jnp.asarray(rng.randn(2, k, k))

    def loss(x):
        u, s, v = svd(x)
        return jnp.sum(rev_svd(u, 1.0 / s, v) * c) + jnp.sum(jnp.log(s))

    g = np.asarray(jax.grad(loss)(a))
    d = jnp.asarray(rng.randn(2, k, k))
    h = 1e-6
    fd = (loss(a + h * d) - loss(a - h * d)) / (2 * h)
    np.testing.assert_allclose(np.sum(g * np.asarray(d)), float(fd),
                               rtol=1e-6)
