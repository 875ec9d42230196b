"""
Kernelized ETKF (KETKF) analysis core.

Functional JAX equivalent of the reference's ``KETKFModule``
(/root/reference/pytassim/core/ketkf.py:29-94): the same regularized
weight-space solve as the ETKF, but the Gram matrix comes from an arbitrary
kernel and is double-centered in feature space.

Kernels are plain callables ``kernel(x, y) -> gram`` over the trailing two
dims (see :mod:`tpu_assim.ops.kernels`); everything broadcasts over leading
batch dimensions so the localized variant (LKETKF) evaluates all grid columns
in one batched call.
"""

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from tpu_assim.ops.etkf import etkf_weights_from_gram, etkf_prior_weights

__all__ = ["ketkf_weights", "center_gram", "ketkf_cheb_analysis"]


def center_gram(
    k_perts: jnp.ndarray, k_obs: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Double-center the perturbation Gram matrix and center the obs Gram
    vector, with the exact operation order of the reference
    (pytassim/core/ketkf.py:77-89):

        m_row  = mean_cols(K_zz)                  (row means, keepdim)
        m_part = m_row - mean(m_row)              (row means minus total mean)
        K_zz_c = K_zz - mean_rows(K_zz) - m_part
        K_zy_c = K_zy - mean_rows(K_zy) - m_part
    """
    k_partial_mean = jnp.mean(k_perts, axis=-1, keepdims=True)
    k_partial_mean = k_partial_mean - jnp.mean(k_partial_mean, axis=-2, keepdims=True)
    k_perts_centered = (
        k_perts - jnp.mean(k_perts, axis=-2, keepdims=True) - k_partial_mean
    )
    k_obs_centered = k_obs - jnp.mean(k_obs, axis=-2, keepdims=True)
    k_obs_centered = k_obs_centered - k_partial_mean
    return k_perts_centered, k_obs_centered


def ketkf_weights(
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    kernel: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    inf_factor: jnp.ndarray | float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> jnp.ndarray:
    """KETKF ensemble weights (reference: pytassim/core/ketkf.py:65-94 with
    the forward template of core/etkf.py:79-103).

    Parameters
    ----------
    normed_perts : [..., k, l] normalized obs-space ensemble perturbations.
    normed_obs : [..., 1, l] (or [..., l]) normalized innovations.
    kernel : callable Gram function, e.g. :class:`tpu_assim.ops.kernels.GaussKernel`.
    inf_factor : inflation factor rho (l2-regularization of the GP weights).
    method : ``"eigh"`` (exact) or ``"newton"`` (matmul-only Newton-Schulz
        — valid because the double-centered Gram of a PSD kernel
        is itself PSD: centering is the projection ``P K P``).
    newton_iters : iterations for ``method="newton"``.
    """
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = normed_perts.shape[-2]
    if normed_perts.shape[-1] == 0:
        prior = etkf_prior_weights(ens_size, inf_factor, dtype=normed_perts.dtype)
        return jnp.broadcast_to(
            prior, normed_perts.shape[:-2] + (ens_size, ens_size)
        )
    k_perts = kernel(normed_perts, normed_perts)
    k_obs = kernel(normed_perts, normed_obs)
    k_perts_centered, k_obs_centered = center_gram(k_perts, k_obs)
    w_mean, w_perts, _ = etkf_weights_from_gram(
        k_perts_centered, k_obs_centered, ens_size, inf_factor,
        method=method, newton_iters=newton_iters,
    )
    return w_mean + w_perts


def ketkf_cheb_analysis(
    scaled_perts: jnp.ndarray,
    scaled_obs: jnp.ndarray,
    kernel: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    inf_factor: jnp.ndarray | float,
    sp: jnp.ndarray,
    mean: jnp.ndarray,
    degree: int = 16,
) -> jnp.ndarray:
    """Batched kernelized analysis WITHOUT materializing the [g, k, k]
    weight matrices or eigendecomposing the kernel Grams — the KETKF twin
    of the LETKF ``cheb`` solver (docs/solvers.md §4).

    The per-column analysis only ever needs two matrix functions of
    ``A = Gc + reg I`` (``Gc`` the double-centered kernel Gram,
    ``reg = (K-1)/rho``) acting on the state-perturbation VECTOR:

        out[m, c] = mean[c] + sp_c^T A_c^{-1} q_c
                            + sqrt(K-1) (A_c^{-1/2} sp_c)[m]

    (``q_c`` the centered obs Gram vector; both terms follow from
    ``W = w_mean + w_perts`` of :func:`ketkf_weights` contracted with
    ``sp`` — reference math core/etkf.py:57-77 + base.py:256-278). With
    ``X = I + Gc/reg`` (spectrum in ``[1, 1 + tr(Gc)/reg]``), both are
    degree-``degree`` Chebyshev expansions evaluated by a Clenshaw
    recurrence of batched mat-vecs — O(d k^2) per column instead of the
    O(k^3) batched eigendecomposition, and work XLA fuses
    on its own (no hand-written kernel needed: the operands are genuinely batched
    matvecs). Degenerate columns (all-zero scaled inputs) give
    ``Gc = 0, q = 0`` exactly (double-centering annihilates the constant
    Gram), so the output is the reference's empty-obs path
    ``mean + sqrt(rho) sp``.

    Parameters
    ----------
    scaled_perts : [g, k, nb] sqrt(taper)-scaled normalized obs-space
        perturbations per column.
    scaled_obs : [g, 1, nb] scaled innovations per column.
    sp / mean : [ns, k, g] state perturbations / [ns, g] means of ns
        stacked (var, time) slices sharing the solve.
    degree : Chebyshev degree (16 covers the tapered-kernel conditioning
        of the built-in kernels at ~1e-6; raise for long-tailed spectra —
        the caller can bound ``1 + tr(Gc)/reg`` cheaply).

    Returns the analysis [ns, k, g].
    """
    from tpu_assim.ops.window import _cheb_nodes_dct

    hp = jax.lax.Precision.HIGHEST
    dtype = scaled_perts.dtype
    k = scaled_perts.shape[-2]
    ens_size = sp.shape[-2]
    assert k == ens_size, (k, ens_size)
    reg = (ens_size - 1) / jnp.asarray(inf_factor, dtype)

    k_perts = kernel(scaled_perts, scaled_perts)           # [g, k, k]
    k_obs = kernel(scaled_perts, scaled_obs)               # [g, k, 1]
    gc, qc = center_gram(k_perts, k_obs)

    # per-column spectral bound of X = I + Gc/reg: Gc is PSD (P K P), so
    # lam_max <= 1 + tr(Gc)/reg; the epsilon floors the zero-width
    # interval of degenerate (empty-obs) columns
    tr = jnp.clip(jnp.trace(gc, axis1=-2, axis2=-1), 0.0, None)
    lam = 1.0 + tr / reg + jnp.asarray(1e-6, dtype)        # [g]

    nodes, dct = _cheb_nodes_dct(degree)
    nodes = jnp.asarray(nodes, dtype)
    dct = jnp.asarray(dct, dtype)
    x_nodes = 1.0 + (lam[:, None] - 1.0) * (nodes[None, :] + 1.0) / 2.0
    c_inv = jnp.einsum("gj,mj->gm", 1.0 / x_nodes, dct, precision=hp)
    c_isq = jnp.einsum("gj,mj->gm", 1.0 / jnp.sqrt(x_nodes), dct,
                       precision=hp)

    v = jnp.transpose(sp, (2, 1, 0)).astype(dtype)         # [g, k, ns]
    a_scale = (2.0 / (lam - 1.0))[:, None, None]
    b_shift = ((lam + 1.0) / (lam - 1.0))[:, None, None]

    def t_of_x(u):
        xu = u + jnp.einsum("gij,gjn->gin", gc, u, precision=hp) / reg
        return a_scale * xu - b_shift * u

    def clenshaw(coeffs, v):
        b1 = jnp.zeros_like(v)
        b2 = jnp.zeros_like(v)
        for m in range(degree, 0, -1):
            b1, b2 = (coeffs[:, m][:, None, None] * v + 2.0 * t_of_x(b1)
                      - b2), b1
        return coeffs[:, 0][:, None, None] * v + t_of_x(b1) - b2

    u_inv = clenshaw(c_inv, v)                             # X^{-1} sp
    u_isq = clenshaw(c_isq, v)                             # X^{-1/2} sp
    # scalar mean-update per (column, slice): sp^T A^{-1} q = u_inv.q/reg
    s1 = jnp.einsum("gkn,gk->gn", u_inv, qc[..., 0],
                    precision=hp) / reg
    alpha = jnp.sqrt((ens_size - 1) / reg)                 # = sqrt(rho)
    out = (mean[:, None, :]
           + jnp.transpose(s1, (1, 0))[:, None, :]
           + alpha * jnp.transpose(u_isq, (2, 1, 0)))
    return out
