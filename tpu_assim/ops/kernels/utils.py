"""
Kernel math helpers (reference: /root/reference/pytassim/kernels/utils.py:38-110).

All helpers operate on the trailing two dims (samples x features) and
broadcast over leading batch dims, so kernelized per-gridpoint solves batch
over the whole grid.
"""

import jax
import jax.numpy as jnp

__all__ = ["dot_product", "distance_matrix", "euclidean_dist"]


def dot_product(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Pairwise dot products ``x y^T`` over trailing dims
    (reference: kernels/utils.py:57)."""
    # HIGHEST: kernel Grams feed the KETKF inverse; a TF32 product would
    # cost ~3 digits there
    return jnp.einsum("...ij,...kj->...ik", x, y,
                      precision=jax.lax.Precision.HIGHEST)


def distance_matrix(x: jnp.ndarray, y: jnp.ndarray, norm: float = 2.0) -> jnp.ndarray:
    """Pairwise p-norm distance matrix (reference: kernels/utils.py:61-87,
    torch.cdist). Implemented directly: for p=2 via the Gram expansion
    (one matrix product), otherwise via broadcast differences."""
    if norm == 2.0:
        # ||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y ; clamp for roundoff.
        sq = (
            jnp.sum(jnp.square(x), axis=-1)[..., :, None]
            + jnp.sum(jnp.square(y), axis=-1)[..., None, :]
            - 2.0 * dot_product(x, y)
        )
        return jnp.sqrt(jnp.clip(sq, 0.0, None))
    diff = jnp.abs(x[..., :, None, :] - y[..., None, :, :])
    return jnp.sum(diff**norm, axis=-1) ** (1.0 / norm)


def euclidean_dist(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Squared euclidean distance matrix (reference: kernels/utils.py:90-110)."""
    sq = (
        jnp.sum(jnp.square(x), axis=-1)[..., :, None]
        + jnp.sum(jnp.square(y), axis=-1)[..., None, :]
        - 2.0 * dot_product(x, y)
    )
    return jnp.clip(sq, 0.0, None)
