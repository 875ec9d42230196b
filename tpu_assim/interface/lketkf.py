"""
Localized kernelized ETKF (LKETKF).

JAX rebuild of /root/reference/pytassim/interface/lketkf.py:34-116:
the per-gridpoint kernelized solve. The reference reuses the LETKF
per-gridpoint Python loop with the bridged KETKF module and sqrt-weight
scaling of the localized inputs (wrapper.py:86-99); here each grid chunk
scales the shared obs-space inputs by ``sqrt(w)`` per column and evaluates
the kernelized solve batched over columns.

Exactness note: for every built-in kernel except :class:`ModuleKernel`, the
kernel value depends on its inputs only through dot products or pairwise
distances, so zero-scaled (masked-out) observation components contribute
exactly nothing — the fixed-size formulation equals the reference's ragged
subsets. A :class:`ModuleKernel` with a nonlinear feature map sees the padded
zeros; use a mask-aware feature map there.
"""

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp

from tpu_assim.interface.ketkf import KETKF
from tpu_assim.interface.mixin_local import DomainLocalizedMixin, map_grid_chunked
from tpu_assim.observation import Observation
from tpu_assim.ops.ketkf import ketkf_weights
from tpu_assim.state import EnsembleState

__all__ = ["LKETKF"]


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))
def _lketkf_solve(
    localization, chunksize, method, newton_iters, max_obs, selection,
    strict, kernel, ens_obs_perts, innovations, grid_info, obs_info,
    inf_factor,
):
    from tpu_assim.ops.localization import (
        neighborhood_select,
        neighborhood_select_window,
        safe_sqrt,
    )

    def chunk_fn(grid_chunk):
        if localization is not None and max_obs is not None:
            # Fast localized path: fixed-size obs
            # neighborhoods — O(g * k * nb) instead of the dense
            # O(g * k * o) scaled-perts tensor. Exact under the same
            # condition as LETKF (no column with more nonzero-taper obs
            # than max_obs) AND for every kernel whose value depends on
            # its inputs only through dot products / pairwise distances:
            # selecting the nonzero-scaled components equals keeping the
            # zero-scaled ones (module docstring; reference ragged
            # contract: wrapper.py:86-99).
            if selection == "window":
                idx, w_nbh = neighborhood_select_window(
                    localization, grid_chunk, obs_info, max_obs,
                    strict=strict,
                )
            else:
                idx, w_nbh = neighborhood_select(
                    localization, grid_chunk, obs_info, max_obs
                )
            sqrt_w = safe_sqrt(w_nbh).astype(ens_obs_perts.dtype)  # [c, nb]
            scaled_perts = (
                ens_obs_perts[:, idx].transpose(1, 0, 2)
                * sqrt_w[:, None, :]
            )                                                # [c, k, nb]
            scaled_obs = (innovations[idx] * sqrt_w)[:, None, :]
            return ketkf_weights(
                scaled_perts, scaled_obs, kernel, inf_factor,
                method=method, newton_iters=newton_iters,
            )
        if localization is None:
            w_loc = jnp.ones(
                (grid_chunk.shape[0], obs_info.shape[0]),
                dtype=ens_obs_perts.dtype,
            )
        else:
            w_loc = localization.taper_weights(grid_chunk, obs_info).astype(
                ens_obs_perts.dtype
            )
        sqrt_w = safe_sqrt(w_loc)  # [c, l]; zero-weight-gradient safe
        scaled_perts = ens_obs_perts[None, :, :] * sqrt_w[:, None, :]
        scaled_obs = (innovations[None, :] * sqrt_w)[:, None, :]
        return ketkf_weights(scaled_perts, scaled_obs, kernel, inf_factor,
                             method=method, newton_iters=newton_iters)

    return map_grid_chunked(chunk_fn, grid_info, chunksize)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _lketkf_gram_trace_bound(
    localization, chunksize, max_obs, selection, strict,
    kernel, ens_obs_perts, grid_info, obs_info,
):
    """Max per-column trace bound of the centered kernel Gram:
    ``tr(P K P) <= tr(K) = sum_m k(z_m, z_m)`` with ``z_m`` the member's
    sqrt(taper)-scaled feature vector — the kernelized analog of the
    LETKF auto-degree spectral bound (interface/letkf.py:
    _auto_cheb_degree). Diagonal kernel values only: O(g k nb)."""
    from tpu_assim.ops.localization import (
        neighborhood_select,
        neighborhood_select_window,
        safe_sqrt,
    )

    k = ens_obs_perts.shape[0]

    def chunk_fn(grid_chunk):
        if localization is not None and max_obs is not None:
            if selection == "window":
                # strict=False HERE deliberately: this pass only sizes the
                # Chebyshev degree; a max_obs overflow would NaN-poison
                # the measured bound (and then the degree) while the
                # SOLVE pass enforces strictness on the analysis itself
                idx, w_nbh = neighborhood_select_window(
                    localization, grid_chunk, obs_info, max_obs,
                    strict=False,
                )
            else:
                idx, w_nbh = neighborhood_select(
                    localization, grid_chunk, obs_info, max_obs
                )
            sqrt_w = safe_sqrt(w_nbh).astype(ens_obs_perts.dtype)
            scaled = (ens_obs_perts[:, idx].transpose(1, 0, 2)
                      * sqrt_w[:, None, :])             # [c, k, nb]
        else:
            if localization is None:
                w_loc = jnp.ones(
                    (grid_chunk.shape[0], obs_info.shape[0]),
                    dtype=ens_obs_perts.dtype,
                )
            else:
                w_loc = localization.taper_weights(
                    grid_chunk, obs_info
                ).astype(ens_obs_perts.dtype)
            sqrt_w = safe_sqrt(w_loc)
            scaled = ens_obs_perts[None, :, :] * sqrt_w[:, None, :]
        c, _, nb = scaled.shape
        flat = scaled.reshape(c * k, 1, nb)
        diag = kernel(flat, flat).reshape(c, k)         # k(z_m, z_m)
        return jnp.sum(diag, axis=-1)                   # [c]

    tr = map_grid_chunked(chunk_fn, grid_info, chunksize)
    return jnp.max(tr)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _lketkf_cheb_analysis(
    localization, chunksize, max_obs, selection, strict, degree,
    kernel, ens_obs_perts, innovations, grid_info, obs_info, inf_factor,
    data,
):
    """Fused kernelized solve+apply: the full [v, t, k, g] analysis
    WITHOUT materializing the [g, k, k] weights or eigendecomposing the
    kernel Grams (:func:`tpu_assim.ops.ketkf.ketkf_cheb_analysis`) — the
    LKETKF twin of the LETKF class API's fused paths. Same selection
    semantics as :func:`_lketkf_solve`; chunking bounds the [c, k, k]
    Gram and [c, k, nb] gather buffers."""
    from tpu_assim.ops.ketkf import ketkf_cheb_analysis
    from tpu_assim.ops.localization import (
        neighborhood_select,
        neighborhood_select_window,
        safe_sqrt,
    )

    v, t, k, g = data.shape
    flat = data.reshape(v * t, k, g)
    mean = jnp.mean(flat, axis=1)                      # [ns, g]
    sp = flat - mean[:, None, :]                       # [ns, k, g]

    def chunk_fn(grid_chunk, sp_chunk, mean_chunk):
        if localization is not None and max_obs is not None:
            if selection == "window":
                idx, w_nbh = neighborhood_select_window(
                    localization, grid_chunk, obs_info, max_obs,
                    strict=strict,
                )
            else:
                idx, w_nbh = neighborhood_select(
                    localization, grid_chunk, obs_info, max_obs
                )
            sqrt_w = safe_sqrt(w_nbh).astype(ens_obs_perts.dtype)
            scaled_perts = (
                ens_obs_perts[:, idx].transpose(1, 0, 2)
                * sqrt_w[:, None, :]
            )                                          # [c, k, nb]
            scaled_obs = (innovations[idx] * sqrt_w)[:, None, :]
        else:
            if localization is None:
                w_loc = jnp.ones(
                    (grid_chunk.shape[0], obs_info.shape[0]),
                    dtype=ens_obs_perts.dtype,
                )
            else:
                w_loc = localization.taper_weights(
                    grid_chunk, obs_info
                ).astype(ens_obs_perts.dtype)
            sqrt_w = safe_sqrt(w_loc)
            scaled_perts = ens_obs_perts[None, :, :] * sqrt_w[:, None, :]
            scaled_obs = (innovations[None, :] * sqrt_w)[:, None, :]
        return ketkf_cheb_analysis(
            scaled_perts, scaled_obs, kernel, inf_factor, sp_chunk,
            mean_chunk, degree=degree,
        )                                              # [ns, k, c]

    if chunksize is None or chunksize >= g:
        out = chunk_fn(grid_info, sp, mean)
        return out.reshape(v, t, k, g).astype(data.dtype)
    n_chunks = -(-g // chunksize)
    pad = n_chunks * chunksize - g
    gi_p = jnp.concatenate(
        [grid_info,
         jnp.broadcast_to(grid_info[-1:], (pad,) + grid_info.shape[1:])],
        axis=0,
    ).reshape((n_chunks, chunksize) + grid_info.shape[1:])
    sp_p = jnp.concatenate(
        [sp, jnp.zeros(sp.shape[:2] + (pad,), sp.dtype)], axis=-1
    ).reshape(sp.shape[:2] + (n_chunks, chunksize))
    mean_p = jnp.concatenate(
        [mean, jnp.zeros((mean.shape[0], pad), mean.dtype)], axis=-1
    ).reshape((mean.shape[0], n_chunks, chunksize))
    out = jax.lax.map(
        lambda args: chunk_fn(args[0], args[1], args[2]),
        (gi_p, jnp.moveaxis(sp_p, 2, 0), jnp.moveaxis(mean_p, 1, 0)),
    )                                                  # [n_chunks, ns, k, c]
    out = jnp.moveaxis(out, 0, 2).reshape(
        (out.shape[1], k, n_chunks * chunksize)
    )[..., :g]
    return out.reshape(v, t, k, g).astype(data.dtype)


class LKETKF(DomainLocalizedMixin, KETKF):
    """Localized kernelized ETKF (reference: interface/lketkf.py:34).

    ``max_obs`` switches the localized solve to fixed-size obs
    neighborhoods (``selection`` = ``"topk"`` or ``"window"``, same
    semantics as :class:`~tpu_assim.interface.LETKF`): O(g * k * nb)
    instead of the dense O(g * k * o) scaled tensor — both faster and the
    memory fix for large grids. Exact whenever no column has more
    nonzero-taper obs than ``max_obs`` and the kernel is dot-product /
    distance based (module docstring); ``max_obs_strict`` NaN-poisons
    window-selection violations."""

    def __init__(
        self,
        localization=None,
        kernel=None,
        inf_factor: float = 1.0,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        forward_model=None,
        method: str = "eigh",
        newton_iters: int = 25,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
        cheb_degree: Optional[int] = None,
    ):
        super().__init__(
            kernel=kernel,
            inf_factor=inf_factor,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
            forward_model=forward_model,
            method=method,
            newton_iters=newton_iters,
        )
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.max_obs_strict = max_obs_strict
        self.cheb_degree = cheb_degree
        if method == "cheb" and weight_save_path is not None:
            raise ValueError(
                "method='cheb' never materializes the weight matrices; "
                "use method='eigh'/'newton' with weight_save_path"
            )

    def __str__(self):
        return "Localized KETKF(inf_factor={0}, loc={1}, kernel={2})".format(
            self.inf_factor, str(self.localization), str(self.kernel)
        )

    def __repr__(self):
        return "LKETKF({0},{1},{2})".format(
            repr(self.inf_factor), repr(self.localization), repr(self.kernel)
        )

    def _estimate_and_apply(
        self,
        state: EnsembleState,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> EnsembleState:
        """``method="cheb"``: fused kernelized solve+apply — the obs-space
        Chebyshev solve is shared across every (var, time) slice and the
        [g, k, k] weights are never materialized (same contract as
        LETKF's fused paths; math identical to estimate + apply)."""
        if self.method != "cheb":
            return super()._estimate_and_apply(state, filtered_obs, ens_obs)
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        grid_info = state.grid_info()
        degree = self.cheb_degree
        if degree is None:
            # auto: measured spectral bound of X = I + Gc/reg, exactly as
            # LETKF's auto degree — tr(Gc) <= sum_m k(z_m, z_m) per column
            from tpu_assim.ops.window import cheb_degree_for

            k = ens_obs_perts.shape[0]
            reg = (k - 1) / float(self.inf_factor)
            tr_max = float(_lketkf_gram_trace_bound(
                self.localization, self.chunksize, self.max_obs,
                self.selection, self.max_obs_strict, self.kernel,
                ens_obs_perts, grid_info, obs_info,
            ))
            degree = cheb_degree_for(1.0 + max(tr_max, 0.0) / reg)
        analysis_data = _lketkf_cheb_analysis(
            self.localization,
            self.chunksize,
            self.max_obs,
            self.selection,
            self.max_obs_strict,
            int(degree),
            self.kernel,
            ens_obs_perts,
            innovations,
            grid_info,
            obs_info,
            jnp.asarray(self.inf_factor, dtype=ens_obs_perts.dtype),
            state.data,
        )
        return state.replace(data=analysis_data)

    def estimate_weights(
        self,
        state: EnsembleState,
        filtered_obs: List[Observation],
        ens_obs: List[jnp.ndarray],
    ) -> jnp.ndarray:
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        grid_info = state.grid_info()
        if self.method == "cheb":
            # direct weight requests on a cheb-configured instance get the
            # exact eigh weights (the LETKF fused classes do the same)
            return _lketkf_solve(
                self.localization, self.chunksize, "eigh",
                self.newton_iters, self.max_obs, self.selection,
                self.max_obs_strict, self.kernel, ens_obs_perts,
                innovations, grid_info, obs_info,
                jnp.asarray(self.inf_factor, dtype=ens_obs_perts.dtype),
            )
        return _lketkf_solve(
            self.localization,
            self.chunksize,
            self.method,
            self.newton_iters,
            self.max_obs,
            self.selection,
            self.max_obs_strict,
            self.kernel,
            ens_obs_perts,
            innovations,
            grid_info,
            obs_info,
            jnp.asarray(self.inf_factor, dtype=ens_obs_perts.dtype),
        )
