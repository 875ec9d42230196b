"""
ETKF weight-space analysis core.

Functional JAX equivalent of the reference's ``ETKFModule``
(/root/reference/pytassim/core/etkf.py:29-103). Given R^{-1/2}-normalized
observation-space ensemble perturbations ``Z`` (ens x obs) and normalized
innovations ``y`` (obs,), produce the K x K ensemble weight matrix

    W = w_mean + W'   with
    C_a = (Z Z^T + (K-1)/rho I)^{-1}          (analysed weight covariance)
    w_mean = C_a Z y^T
    W'  = ((K-1) C_a)^{1/2}                  (symmetric square root via EVD)

All functions broadcast over arbitrary leading batch dimensions, so the LETKF
simply calls the batched localized variant once for the whole grid instead of
looping per column (reference loop: pytassim/interface/letkf.py:127-143).
"""

from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_assim.ops.linalg import (
    evd,
    rev_evd,
    matrix_product,
    inv_and_inv_sqrt_psd_eigh,
    inv_sqrt_psd_newton,
    sqrt_and_inv_sqrt_psd_newton,
    inv_spd_newton,
)

__all__ = [
    "etkf_weights",
    "etkf_weights_from_gram",
    "etkf_prior_weights",
    "letkf_weights_dense",
    "letkf_weights_nbh",
]


def etkf_prior_weights(
    ens_size: int, inf_factor: jnp.ndarray | float = 1.0, dtype=jnp.float64
) -> jnp.ndarray:
    """Inflated prior weights ``sqrt(rho) * I`` returned for the empty-obs
    path (reference: pytassim/core/etkf.py:91-95 with core/base.py:48-62)."""
    inf_factor = jnp.asarray(inf_factor, dtype=dtype)
    return jnp.sqrt(inf_factor) * jnp.eye(ens_size, dtype=dtype)


def etkf_weights_from_gram(
    kernel_perts: jnp.ndarray,
    kernel_obs: jnp.ndarray,
    ens_size: int,
    inf_factor: jnp.ndarray | float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solve for (w_mean, w_perts, cov_analysed) from a Gram matrix.

    The shared inner solve of ETKF and KETKF
    (reference: pytassim/core/etkf.py:57-77): eigendecompose the (centered)
    Gram matrix with regularizer ``(K-1)/rho``, recompose the analysed
    covariance and the symmetric square-root perturbation weights.

    Parameters
    ----------
    kernel_perts : [..., k, k] Gram matrix of the normalized perturbations.
    kernel_obs : [..., k, 1] Gram vector against the normalized innovations.
    ens_size : static ensemble size K.
    inf_factor : covariance inflation factor ``rho`` entering as the
        regularizer ``(K-1)/rho`` (reference: core/etkf.py:67).
    method : ``"eigh"`` — exact eigendecomposition (bitwise-comparable to the
        reference math). ``"newton"`` — matmul-only coupled Newton–Schulz iteration
        computing ``(G + reg I)^{-1}`` and ``(G + reg I)^{-1/2}`` directly as
        matrix products; mathematically identical for PSD Gram matrices (the
        eigenvalue clamp of the eigh path is then inactive), accurate to
        working precision.
    newton_iters : iteration count for ``method="newton"``.
    """
    reg_value = (ens_size - 1) / jnp.asarray(inf_factor, dtype=kernel_perts.dtype)
    if method == "newton":
        k = kernel_perts.shape[-1]
        eye = jnp.eye(k, dtype=kernel_perts.dtype)
        a_mat = kernel_perts + reg_value * eye
        cov_analysed, a_inv_sqrt = inv_sqrt_psd_newton(
            a_mat, num_iters=newton_iters, lam_min=reg_value
        )
        w_mean = jnp.einsum("...ij,...jl->...il", cov_analysed, kernel_obs,
                            precision=jax.lax.Precision.HIGHEST)
        w_perts = jnp.sqrt(jnp.asarray(ens_size - 1, kernel_perts.dtype)) * a_inv_sqrt
        return w_mean, w_perts, cov_analysed
    if method != "eigh":
        raise ValueError(f"unknown method {method!r}; use 'eigh' or 'newton'")
    # same math as evd + two rev_evd recompositions (core/etkf.py:57-77),
    # via the Daleckii–Krein-differentiable solve: one eigh shared by
    # (G+reg)^{-1} and (G+reg)^{-1/2}, NaN-free gradients on the degenerate
    # spectra localized Grams always have (linalg.inv_and_inv_sqrt_psd_eigh)
    cov_analysed, a_inv_sqrt = inv_and_inv_sqrt_psd_eigh(
        kernel_perts, reg_value
    )
    w_mean = jnp.einsum("...ij,...jl->...il", cov_analysed, kernel_obs,
                        precision=jax.lax.Precision.HIGHEST)
    w_perts = jnp.sqrt(
        jnp.asarray(ens_size - 1, kernel_perts.dtype)
    ) * a_inv_sqrt
    return w_mean, w_perts, cov_analysed


def etkf_weights(
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    inf_factor: jnp.ndarray | float = 1.0,
) -> jnp.ndarray:
    """ETKF ensemble weights (reference forward: pytassim/core/etkf.py:79-103).

    Parameters
    ----------
    normed_perts : [..., k, l] R^{-1/2}-normalized obs-space ens perturbations.
    normed_obs : [..., 1, l] (or [..., l]) normalized innovations.
    inf_factor : inflation factor rho.

    Returns
    -------
    weights : [..., k, k] ensemble weights ``w_mean + w_perts`` (mean weights
        broadcast over columns, matching the reference's ``w_mean + W'``).
    """
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = normed_perts.shape[-2]
    if normed_perts.shape[-1] == 0:
        # Static empty-obs path: inflated prior (core/etkf.py:91-95).
        prior = etkf_prior_weights(
            ens_size, inf_factor, dtype=normed_perts.dtype
        )
        return jnp.broadcast_to(
            prior, normed_perts.shape[:-2] + (ens_size, ens_size)
        )
    kernel_perts = matrix_product(normed_perts, normed_perts)
    kernel_obs = matrix_product(normed_perts, normed_obs)
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor
    )
    return w_mean + w_perts


def letkf_weights_dense(
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    obs_weights: jnp.ndarray,
    inf_factor: jnp.ndarray | float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> jnp.ndarray:
    """Localized ETKF weights for a whole batch of grid columns at once.

    The reference localizes by masking each grid point's obs subset and
    scaling perturbations and innovations by ``sqrt(w)``
    (pytassim/interface/wrapper.py:86-99). Because scaled perturbations only
    ever enter through the Gram products, ``Z_loc Z_loc^T = Z diag(w) Z^T``
    and ``Z_loc y_loc^T = Z diag(w) y^T`` — so the masked ragged subsets can
    be replaced *exactly* by weighting inside two large einsums over the full
    obs vector (zero-weight obs contribute nothing), which is precisely the
    matmul formulation. When a column's weights are all zero, the solve
    degenerates to the inflated prior ``sqrt(rho) I`` — the same result as the
    reference's empty-obs path, again exactly.

    Parameters
    ----------
    normed_perts : [k, l] normalized obs-space perturbations (shared).
    normed_obs : [l] or [1, l] normalized innovations (shared).
    obs_weights : [..., l] per-column localization weights (tapered, >= 0,
        already cut off below epsilon).
    inf_factor : inflation factor rho.

    Returns
    -------
    weights : [..., k, k] per-column ensemble weight matrices.
    """
    normed_obs = normed_obs.reshape(-1)
    ens_size = normed_perts.shape[-2]
    # Batched Gram matrices: G[g] = Z diag(w_g) Z^T, zy[g] = Z diag(w_g) y.
    # HIGHEST precision: these feed a matrix inverse; reduced-precision products would
    # dominate the error budget (see matrix_product).
    hp = jax.lax.Precision.HIGHEST
    kernel_perts = jnp.einsum(
        "kl,...l,ml->...km", normed_perts, obs_weights, normed_perts,
        precision=hp,
    )
    kernel_obs = jnp.einsum(
        "kl,...l,l->...k", normed_perts, obs_weights, normed_obs,
        precision=hp,
    )[..., None]
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor,
        method=method, newton_iters=newton_iters,
    )
    return w_mean + w_perts


def letkf_weights_nbh(
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    nbh_idx: jnp.ndarray,
    nbh_weights: jnp.ndarray,
    inf_factor: jnp.ndarray | float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> jnp.ndarray:
    """Localized ETKF weights over fixed-size obs neighborhoods.

    Same math as :func:`letkf_weights_dense`, but each grid column's Gram
    products run over only its ``nb = nbh_idx.shape[-1]`` selected
    observations (see :func:`tpu_assim.ops.localization.neighborhood_select`)
    instead of the full obs vector — for a Gaspari-Cohn radius covering a
    small fraction of the domain this cuts the Gram FLOPs by ``o / nb``
    (the reference gets the same effect from ragged masked subsets,
    pytassim/interface/wrapper.py:91-97).

    Parameters
    ----------
    normed_perts : [k, o] normalized obs-space perturbations (shared).
    normed_obs : [o] normalized innovations (shared).
    nbh_idx : [g, nb] int obs indices per grid column.
    nbh_weights : [g, nb] localization weights per selected obs (0 = padded).

    Returns
    -------
    weights : [g, k, k] per-column ensemble weight matrices.
    """
    normed_obs = normed_obs.reshape(-1)
    ens_size = normed_perts.shape[-2]
    z = normed_perts[:, nbh_idx]          # [k, g, nb]
    y = normed_obs[nbh_idx]               # [g, nb]
    hp = jax.lax.Precision.HIGHEST
    if method == "woodbury":
        return _letkf_weights_nbh_woodbury(
            z, y, nbh_weights, ens_size, inf_factor, newton_iters
        )
    kernel_perts = jnp.einsum("kgn,gn,mgn->gkm", z, nbh_weights, z,
                              precision=hp)
    kernel_obs = jnp.einsum("kgn,gn,gn->gk", z, nbh_weights, y,
                            precision=hp)[..., None]
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor,
        method=method, newton_iters=newton_iters,
    )
    return w_mean + w_perts


def _letkf_weights_nbh_woodbury(
    z: jnp.ndarray,
    y: jnp.ndarray,
    nbh_weights: jnp.ndarray,
    ens_size: int,
    inf_factor,
    newton_iters: int = 10,
) -> jnp.ndarray:
    """Dual-space (Woodbury) localized ETKF solve over obs neighborhoods.

    For ``nb < K`` every matrix function of ``A = Zh Zh^T + reg I_K`` can be
    computed from the nb x nb matrix ``X = I + Zh^T Zh / reg`` (``Zh`` the
    sqrt-weight-scaled neighborhood perturbations [K, nb]):

        w_mean   = Zh X^{-1} yh / reg
        A^{-1/2} = reg^{-1/2} [I_K - Zh (X^{1/2} + I)^{-1} X^{-1/2} Zh^T / reg]

    (the second identity follows from applying f(x)=x^{-1/2} on the nonzero
    eigenspace of Zh Zh^T and simplifying (f(S+reg) - f(reg)) S^{-1} to
    ``-(X^{1/2}+I)^{-1} X^{-1/2} / reg``). This shrinks the Newton–Schulz
    iterations from K x K to nb x nb matmuls — ~(K/nb)^3 fewer FLOPs in the
    iteration — and X has spectrum in [1, 1 + tr(S)/reg], so the scaled
    iteration converges in a handful of steps. Exactly the same analysis
    weights as the eigh path, at working precision.
    """
    dtype = z.dtype
    k = ens_size
    nb = z.shape[-1]
    reg = (k - 1) / jnp.asarray(inf_factor, dtype=dtype)
    hp = jax.lax.Precision.HIGHEST
    from tpu_assim.ops.localization import safe_sqrt

    sw = safe_sqrt(nbh_weights).astype(dtype)         # [g, nb]
    zh = z.transpose(1, 0, 2) * sw[:, None, :]        # [g, k, nb]
    yh = y * sw                                       # [g, nb]
    eye_nb = jnp.eye(nb, dtype=dtype)
    s_mat = jnp.einsum("gkn,gkm->gnm", zh, zh, precision=hp)
    x = eye_nb + s_mat / reg
    x_sqrt, x_inv_sqrt = sqrt_and_inv_sqrt_psd_newton(
        x, num_iters=newton_iters, lam_min=1.0
    )
    x_inv = jnp.einsum("gij,gjk->gik", x_inv_sqrt, x_inv_sqrt, precision=hp)
    n_mat = jnp.einsum(
        "gij,gjk->gik",
        inv_spd_newton(x_sqrt + eye_nb, num_iters=newton_iters, lam_min=2.0),
        x_inv_sqrt,
        precision=hp,
    )
    w_mean = jnp.einsum("gkn,gnm,gm->gk", zh, x_inv, yh,
                        precision=hp) / reg            # [g, k]
    zn = jnp.einsum("gkn,gnm->gkm", zh, n_mat, precision=hp)
    w_perts = jnp.sqrt((k - 1) / reg) * (
        jnp.eye(k, dtype=dtype)
        - jnp.einsum("gkn,gln->gkl", zn, zh, precision=hp) / reg
    )
    return w_mean[..., None] + w_perts
