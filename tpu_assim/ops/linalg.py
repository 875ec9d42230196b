"""
Batched linear-algebra helpers for the analysis cores.

Functional JAX equivalents of the reference's torch helpers
(/root/reference/pytassim/core/utils.py:26-199), generalized to arbitrary
leading batch dimensions so that millions of per-gridpoint K x K solves run as
one batched XLA op instead of a Python loop.

All recompositions are einsums so XLA can fuse scaling into the matmuls.
"""

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "evd",
    "rev_evd",
    "svd",
    "rev_svd",
    "matrix_product",
    "diagonal_add",
    "eigh_psd",
    "inv_and_inv_sqrt_psd_eigh",
    "inv_sqrt_psd_newton",
    "sqrt_and_inv_sqrt_psd_newton",
    "inv_spd_newton",
]


def evd(
    tensor: jnp.ndarray, reg_value: jnp.ndarray | float = 0.0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Eigendecomposition of a symmetric PSD tensor with regularization.

    Mirrors the reference semantics (pytassim/core/utils.py:26-61): the
    eigenvalues of the nearest positive semidefinite matrix are used
    (clamp at 0), then ``reg_value`` is added and inverted eigenvalues are
    returned alongside.

    Parameters
    ----------
    tensor : [..., n, n] symmetric tensor.
    reg_value : scalar added to the (clamped) eigenvalues.

    Returns
    -------
    evals, evects, evals_inv : ([..., n], [..., n, n], [..., n])
    """
    evals, evects = eigh_psd(tensor)
    evals = jnp.clip(evals, 0.0, None)
    evals = evals + reg_value
    evals_inv = 1.0 / evals
    return evals, evects, evals_inv


def rev_evd(evals: jnp.ndarray, evects: jnp.ndarray) -> jnp.ndarray:
    """Recompose ``U diag(evals) U^T`` (pytassim/core/utils.py:64-93)."""
    return jnp.einsum("...ik,...k,...jk->...ij", evects, evals, evects,
                      precision=jax.lax.Precision.HIGHEST)


def svd(
    tensor: jnp.ndarray, reg_value: jnp.ndarray | float = 0.0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reduced SVD with additive regularization of the singular values.

    Matches torch.svd conventions used by the reference
    (pytassim/core/utils.py:96-124): returns ``v`` (not ``v^T``) such that
    ``tensor = u diag(s) v^T``. Singular vectors of a rank-deficient input
    span its null space in an arbitrary basis, as LAPACK's do; callers that
    need a unique answer compose ``u``, ``s`` and ``v`` into a
    rotation-invariant matrix function.
    """
    u, s, vh = jnp.linalg.svd(tensor, full_matrices=False)
    v = jnp.swapaxes(vh, -1, -2)
    return u, s + reg_value, v


def rev_svd(u: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Recompose ``u diag(s) v^T`` (pytassim/core/utils.py:127-150)."""
    return jnp.einsum("...ik,...k,...jk->...ij", u, s, v,
                      precision=jax.lax.Precision.HIGHEST)


def matrix_product(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """``x @ y^T`` over the trailing two dims (pytassim/core/utils.py:153-173).

    ``precision=HIGHEST``: Gram matrices feed matrix inversions, where a
    reduced-precision (TF32 or bf16) product costs ~3 digits in the final
    weights.
    """
    return jnp.einsum("...kl,...ml->...km", x, y,
                      precision=jax.lax.Precision.HIGHEST)


def diagonal_add(tensor: jnp.ndarray, to_add: jnp.ndarray | float = 0.0) -> jnp.ndarray:
    """Add a scalar to the diagonal of the trailing two dims
    (pytassim/core/utils.py:176-199)."""
    n = tensor.shape[-1]
    eye = jnp.eye(n, dtype=tensor.dtype)
    return tensor + to_add * eye


#: Most matrix rows (batch x n) one batched eigensolver call takes. cuSOLVER's
#: batched ``syev`` rejects larger batches (on an H100: [12288, 100, 100] and
#: [16384, 40, 40] run, [16384, 100, 100] and [65536, 40, 40] fail in
#: ``cusolverDnXsyevBatched_bufferSize``); this is under half of the largest
#: size seen to run.
EIGH_MAX_ROWS = 1 << 19


def eigh_psd(tensor: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched symmetric eigendecomposition.

    Same convention as :func:`jnp.linalg.eigh` (ascending eigenvalues,
    eigenvector columns — the reference's ``torch.symeig(..., upper=False)``,
    pytassim/core/utils.py:57). On the GPU this is cuSOLVER's batched
    ``syevd``/``syevj``, as XLA chooses.

    A batch of more than :data:`EIGH_MAX_ROWS` rows runs as a sequence of
    calls over a power-of-two number of chunks. Chunk ``j`` takes every
    ``n_chunks``-th matrix from ``j`` on, so a batch sharded over devices
    in contiguous blocks stays sharded the same way inside every call.
    """
    n = tensor.shape[-1]
    batch_shape = tensor.shape[:-2]
    b = math.prod(batch_shape)
    n_chunks = 1 << max(0, -(-b * n // EIGH_MAX_ROWS) - 1).bit_length()
    if n_chunks == 1:
        return jnp.linalg.eigh(tensor)
    c = -(-b // n_chunks)
    flat = tensor.reshape((b, n, n))
    if c * n_chunks > b:  # pad with identities, discarded below
        eye = jnp.eye(n, dtype=tensor.dtype)
        flat = jnp.concatenate(
            [flat, jnp.broadcast_to(eye, (c * n_chunks - b, n, n))])
    chunks = jnp.swapaxes(flat.reshape((c, n_chunks, n, n)), 0, 1)
    evals, evects = jax.lax.map(jnp.linalg.eigh, chunks)
    evals = jnp.swapaxes(evals, 0, 1).reshape((-1, n))[:b]
    evects = jnp.swapaxes(evects, 0, 1).reshape((-1, n, n))[:b]
    return (evals.reshape(batch_shape + (n,)),
            evects.reshape(batch_shape + (n, n)))


@jax.custom_jvp
def inv_and_inv_sqrt_psd_eigh(
    g_mat: jnp.ndarray, reg: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``((Gc + reg I)^{-1}, (Gc + reg I)^{-1/2})`` of a batched symmetric
    PSD matrix via one eigendecomposition, ``Gc`` the eigenvalue-clamped
    (nearest-PSD) input — the reference's regularized solve
    (pytassim/core/utils.py:26-93 composed as in core/etkf.py:57-77).

    Differentiation note: ``jnp.linalg.eigh``'s VJP divides by eigenvalue
    gaps and NaNs on the degenerate spectra that localized (rank-deficient)
    Gram matrices always have — torch.symeig's backward fails identically,
    so the reference cannot differentiate this case either. The *composed*
    matrix functions are nonetheless smooth in ``G``; this function carries
    the exact Daleckii–Krein JVP (divided differences of the eigenvalue
    maps, derivative on degenerate pairs), making the eigh path
    differentiable everywhere the underlying map is — gradients match the
    matmul-only ``method='newton'`` path (tests/test_differentiable.py).
    """
    evals, evects = eigh_psd(g_mat)
    h = jnp.clip(evals, 0.0, None) + reg
    return rev_evd(1.0 / h, evects), rev_evd(1.0 / jnp.sqrt(h), evects)


@inv_and_inv_sqrt_psd_eigh.defjvp
def _inv_and_inv_sqrt_psd_eigh_jvp(primals, tangents):
    g_mat, reg = primals
    dg, dreg = tangents
    evals, evects = eigh_psd(g_mat)
    dtype = evals.dtype
    eps = jnp.finfo(dtype).eps
    scale = jnp.max(jnp.abs(evals), axis=-1, keepdims=True) + jnp.abs(reg)
    # clamp derivative: active above rounding-level negatives (an exactly
    # PSD matrix perturbed along PSD-preserving directions keeps h' = 1 at
    # eigenvalue 0 — the choice that matches the Newton path and finite
    # differences on the PSD manifold)
    act = (evals > -1e3 * eps * scale).astype(dtype)
    h = jnp.clip(evals, 0.0, None) + reg
    f1 = 1.0 / h
    f2 = 1.0 / jnp.sqrt(h)
    d1 = -act * f1 * f1
    d2 = -0.5 * act * f2 * f1
    out1 = rev_evd(f1, evects)
    out2 = rev_evd(f2, evects)

    hp = jax.lax.Precision.HIGHEST
    m = jnp.einsum("...ki,...kl,...lj->...ij", evects, dg, evects,
                   precision=hp)
    m = 0.5 * (m + jnp.swapaxes(m, -1, -2))
    den = evals[..., :, None] - evals[..., None, :]
    # switch to the derivative mean below sqrt(eps)-relative gaps: both the
    # correct degenerate limit AND the numerically stable branch (the
    # divided difference cancels catastrophically for tiny gaps)
    close = jnp.abs(den) <= jnp.sqrt(eps) * scale[..., None]
    den_safe = jnp.where(close, 1.0, den)

    def matfun_tangent(f, d):
        gamma = jnp.where(
            close,
            0.5 * (d[..., :, None] + d[..., None, :]),
            (f[..., :, None] - f[..., None, :]) / den_safe,
        )
        return jnp.einsum("...ik,...kl,...jl->...ij", evects, gamma * m,
                          evects, precision=hp)

    dreg = jnp.asarray(dreg, dtype)
    dout1 = matfun_tangent(f1, d1) + dreg * rev_evd(-f1 * f1, evects)
    dout2 = matfun_tangent(f2, d2) + dreg * rev_evd(-0.5 * f2 * f1, evects)
    return (out1, out2), (dout1, dout2)


@partial(jax.jit, static_argnames=("num_iters",))
def inv_sqrt_psd_newton(
    a: jnp.ndarray, num_iters: int = 14, lam_min: Optional[float] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Matmul-only inverse and inverse-square-root of a batched SPD matrix.

    Coupled Denman–Beavers/Newton–Schulz iteration: for SPD ``A`` scaled to
    spectral radius < 2, iterate ``Y <- Y (3I - Z Y)/2``, ``Z <- (3I - Z Y)/2 Z``
    which converges to ``Y = A^{-1/2}``, ``Z = A^{1/2}`` (up to the scale
    factor). Every step is a batched K x K matmul — the matmul-only
    alternative to eigendecomposition for the LETKF hot path. Exposed as
    an opt-in solver; the default path uses :func:`evd` for exact parity with
    the reference math.

    Parameters
    ----------
    lam_min : optional known lower bound on the spectrum (for the ETKF solve
        this is exactly the regularizer ``(K-1)/rho``). With it the input is
        scaled by ``2 / (lam_min + lam_max_bound)``, centering the spectrum
        about 1 — the optimal affine scaling, which cuts the linear warm-up
        phase of the iteration roughly in half for well-conditioned inputs.

    Returns ``(a_inv, a_inv_sqrt)``.
    """
    k = a.shape[-1]
    eye = jnp.eye(k, dtype=a.dtype)
    # Spectral-radius upper bound: min(row-sum/infinity norm, trace) — both
    # valid for SPD matrices, cheap, and batched.
    inf_norm = jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1)
    trace = jnp.trace(a, axis1=-2, axis2=-1)
    lam_max = jnp.minimum(inf_norm, trace)[..., None, None]
    if lam_min is not None:
        norm = 0.5 * (lam_max + jnp.asarray(lam_min, a.dtype))
    else:
        norm = lam_max
    norm = jnp.maximum(norm, jnp.finfo(a.dtype).tiny)
    a_n = a / norm

    # Full-precision matmuls: the iteration amplifies rounding, and a
    # reduced-precision f32 product (TF32 on the GPU) loses ~3 digits over
    # ~20 iterations.
    hp = jax.lax.Precision.HIGHEST

    def body(_, yz):
        y, z = yz
        t = 0.5 * (3.0 * eye - jnp.einsum("...ij,...jk->...ik", z, y,
                                          precision=hp))
        y = jnp.einsum("...ij,...jk->...ik", y, t, precision=hp)
        z = jnp.einsum("...ij,...jk->...ik", t, z, precision=hp)
        return y, z

    y0 = a_n
    z0 = jnp.broadcast_to(eye, a.shape)
    y, z = jax.lax.fori_loop(0, num_iters, body, (y0, z0))
    # y -> a_n^{1/2}, z -> a_n^{-1/2}
    sqrt_norm = jnp.sqrt(norm)
    a_inv_sqrt = z / sqrt_norm
    a_inv = jnp.einsum("...ij,...jk->...ik", a_inv_sqrt, a_inv_sqrt,
                       precision=hp)
    return a_inv, a_inv_sqrt


@partial(jax.jit, static_argnames=("num_iters",))
def sqrt_and_inv_sqrt_psd_newton(
    a: jnp.ndarray, num_iters: int = 14, lam_min: Optional[float] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coupled Newton–Schulz returning ``(a_sqrt, a_inv_sqrt)`` — the same
    iteration as :func:`inv_sqrt_psd_newton` exposing the square-root factor
    instead of the inverse."""
    k = a.shape[-1]
    eye = jnp.eye(k, dtype=a.dtype)
    inf_norm = jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1)
    trace = jnp.trace(a, axis1=-2, axis2=-1)
    lam_max = jnp.minimum(inf_norm, trace)[..., None, None]
    if lam_min is not None:
        norm = 0.5 * (lam_max + jnp.asarray(lam_min, a.dtype))
    else:
        norm = lam_max
    norm = jnp.maximum(norm, jnp.finfo(a.dtype).tiny)
    a_n = a / norm
    hp = jax.lax.Precision.HIGHEST

    def body(_, yz):
        y, z = yz
        t = 0.5 * (3.0 * eye - jnp.einsum("...ij,...jk->...ik", z, y,
                                          precision=hp))
        y = jnp.einsum("...ij,...jk->...ik", y, t, precision=hp)
        z = jnp.einsum("...ij,...jk->...ik", t, z, precision=hp)
        return y, z

    y, z = jax.lax.fori_loop(
        0, num_iters, body, (a_n, jnp.broadcast_to(eye, a.shape))
    )
    sqrt_norm = jnp.sqrt(norm)
    return y * sqrt_norm, z / sqrt_norm


@partial(jax.jit, static_argnames=("num_iters",))
def inv_spd_newton(
    a: jnp.ndarray,
    num_iters: int = 12,
    lam_min: Optional[float] = None,
) -> jnp.ndarray:
    """Matmul-only inverse of a batched SPD matrix via Newton–Schulz
    ``V <- V (2I - A V)``, seeded with the optimal scalar ``2/(lmin+lmax) I``.
    """
    k = a.shape[-1]
    eye = jnp.eye(k, dtype=a.dtype)
    inf_norm = jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1)
    trace = jnp.trace(a, axis1=-2, axis2=-1)
    lam_max = jnp.minimum(inf_norm, trace)[..., None, None]
    if lam_min is not None:
        scale = 2.0 / (lam_max + jnp.asarray(lam_min, a.dtype))
    else:
        scale = 1.0 / lam_max
    hp = jax.lax.Precision.HIGHEST

    def body(_, v):
        av = jnp.einsum("...ij,...jk->...ik", a, v, precision=hp)
        return v + jnp.einsum(
            "...ij,...jk->...ik", v, eye - av, precision=hp
        )

    return jax.lax.fori_loop(0, num_iters, body, scale * eye + 0.0 * a)
