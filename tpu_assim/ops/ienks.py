"""
Iterative Ensemble Kalman Smoother (IEnKS) inner-step cores.

Functional JAX equivalents of the reference's
``IEnKSTransformModule`` / ``IEnKSBundleModule``
(/root/reference/pytassim/core/ienks.py:28-175): one Gauss–Newton step in
ensemble-weight space, with a learning rate ``tau`` blending the updated
precision, and (bundle variant) a finite-difference linearization scale
``epsilon``.

Everything broadcasts over leading batch dims so the localized variants run
all grid columns in one batched call.
"""

from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_assim.ops.linalg import (
    inv_and_inv_sqrt_psd_eigh,
    matrix_product,
    diagonal_add,
)

__all__ = ["ienks_transform_step", "ienks_bundle_step"]


def _split_weights(weights: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split a weight matrix into mean and perturbation parts
    (reference: pytassim/core/ienks.py:48-56): subtract the identity, take
    column means as the mean weights, and remove them from the full matrix."""
    weights_deviation = diagonal_add(weights, -1.0)
    weights_mean = jnp.mean(weights_deviation, axis=-1, keepdims=True)
    weights_perts = weights - weights_mean
    return weights_mean, weights_perts


def _decompose_weights(
    weights: jnp.ndarray, ens_size: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Invert the weight perturbations ``W'`` and form the weight-space
    precision ``(K-1) (W' W'^T)^{-1}`` (reference: pytassim/core/ienks.py:
    58-69, which takes both from one SVD ``W' = U S V^T``: ``W'^{-1} =
    V S^{-1} U^T`` and ``U S^{-2} U^T``). One batched LU inverse gives the
    same two matrices: ``(W' W'^T)^{-1} = W'^{-T} W'^{-1}``."""
    w_mean, w_perts = _split_weights(weights)
    w_perts_inv = jnp.linalg.inv(w_perts)
    inv_t = jnp.swapaxes(w_perts_inv, -1, -2)
    w_prec = matrix_product(inv_t, inv_t) * (ens_size - 1)
    return w_mean, w_perts_inv, w_prec


def _get_gradient(
    w_mean: jnp.ndarray,
    dh_dw: jnp.ndarray,
    normed_obs: jnp.ndarray,
    ens_size: int,
) -> jnp.ndarray:
    """Gauss–Newton gradient ``(K-1) w_mean - dH/dW y^T``
    (reference: pytassim/core/ienks.py:79-90)."""
    grad_obs = matrix_product(dh_dw, -normed_obs)
    grad_back = (ens_size - 1) * w_mean
    return grad_back + grad_obs


def _update_covariance(
    w_prec: jnp.ndarray,
    dh_dw: jnp.ndarray,
    ens_size: int,
    tau: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blend the old and new weight precision by the learning rate ``tau``,
    then invert into covariance and square-root perturbation weights
    (reference: pytassim/core/ienks.py:92-106, by SVD). The blended
    precision ``(1-tau) P + tau (dH dH^T + (K-1) I)`` is symmetric positive
    definite, so its SVD is its eigendecomposition: one batched ``eigh``
    (with the NaN-free custom JVP of
    :func:`tpu_assim.ops.linalg.inv_and_inv_sqrt_psd_eigh`) gives the
    inverse and the inverse square root."""
    blended = (1.0 - tau) * w_prec + tau * matrix_product(dh_dw, dh_dw)
    weights_cov, prec_inv_sqrt = inv_and_inv_sqrt_psd_eigh(
        blended, tau * (ens_size - 1.0))
    weights_perts = prec_inv_sqrt * jnp.sqrt(ens_size - 1.0)
    return weights_cov, weights_perts


def _ienks_step(
    weights: jnp.ndarray,
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    tau: jnp.ndarray,
    dh_dw_fn,
) -> jnp.ndarray:
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = weights.shape[-2]
    if normed_perts.shape[-1] == 0:
        # Empty obs: the weights pass through unchanged
        # (reference forward: pytassim/core/ienks.py:126-141).
        return weights
    w_mean, w_perts_inv, w_prec = _decompose_weights(weights, ens_size)
    dh_dw = dh_dw_fn(normed_perts, w_perts_inv)
    grad = _get_gradient(w_mean, dh_dw, normed_obs, ens_size)
    w_cov, w_perts = _update_covariance(w_prec, dh_dw, ens_size, tau)
    delta_weight = jnp.einsum("...ij,...jl->...il", w_cov, grad,
                              precision=jax.lax.Precision.HIGHEST)
    w_mean = w_mean - tau * delta_weight
    return w_mean + w_perts


def ienks_transform_step(
    weights: jnp.ndarray,
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    tau: jnp.ndarray | float = 1.0,
) -> jnp.ndarray:
    """One IEnKS-Transform inner step: the linearized obs operator is
    ``dH/dW = W'^{-1} Z`` (reference: pytassim/core/ienks.py:71-77).

    Parameters
    ----------
    weights : [..., k, k] current ensemble weights.
    normed_perts : [..., k, l] normalized obs-space perturbations of the
        *propagated* ensemble.
    normed_obs : [..., 1, l] normalized innovations.
    tau : learning rate in [0, 1].
    """
    tau = jnp.asarray(tau, dtype=weights.dtype)

    def dh_dw_fn(perts, w_perts_inv):
        return jnp.einsum("...ij,...jl->...il", w_perts_inv, perts,
                          precision=jax.lax.Precision.HIGHEST)

    return _ienks_step(weights, normed_perts, normed_obs, tau, dh_dw_fn)


def ienks_bundle_step(
    weights: jnp.ndarray,
    normed_perts: jnp.ndarray,
    normed_obs: jnp.ndarray,
    tau: jnp.ndarray | float = 1.0,
    epsilon: jnp.ndarray | float = 1e-4,
) -> jnp.ndarray:
    """One IEnKS-Bundle inner step: finite-difference linearization
    ``dH/dW = Z / epsilon`` (reference: pytassim/core/ienks.py:168-174)."""
    tau = jnp.asarray(tau, dtype=weights.dtype)
    epsilon = jnp.asarray(epsilon, dtype=weights.dtype)

    def dh_dw_fn(perts, _w_perts_inv):
        return perts / epsilon

    return _ienks_step(weights, normed_perts, normed_obs, tau, dh_dw_fn)
