"""
Fused, fully-jitted analysis steps.

The reference's hot path crosses xarray -> dask -> numpy -> torch per grid
chunk (/root/reference/pytassim/interface/letkf.py:127-143, wrapper.py:29-63).
Here the complete analysis — obs-operator application, R^{-1/2}
normalization, innovation, Gaspari-Cohn taper, batched weight solve, and
weight application — is one jitted XLA program with zero host round-trips.
These entry points power bench.py and the cycled-DA experiments; the
class-based interface layer (:mod:`tpu_assim.interface`) offers the same math
with the reference's flexible object API.
"""

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_assim.interface.mixin_local import map_grid_chunked
from tpu_assim.ops.etkf import (
    letkf_weights_dense,
    letkf_weights_nbh,
    etkf_weights,
)
from tpu_assim.ops.localization import (
    neighborhood_select,
    neighborhood_select_window,
)

__all__ = [
    "make_letkf_analysis",
    "make_etkf_analysis",
    "make_cycle_step",
    "make_strip_letkf_2d",
    "make_lienks_step",
]


def _normalized_obs_space(ens_obs, obs_vals, obs_var):
    """R^{-1/2} normalization of innovations and obs-space perturbations.

    ens_obs [k, o], obs_vals [o], obs_var [o] (diagonal) or [o, o] (full
    correlated covariance) -> (perts [k, o], innov [o]).

    The correlated case whitens by the Cholesky factor (triangular solve,
    never an explicit inverse) — the reference's uniform ``mul_rcinv``
    contract (observation.py:241-271) extended to the fast entry points, so
    every solver method (incl. the window paths, which consume the
    pre-whitened obs space) accepts a correlated R.
    """
    mean = jnp.mean(ens_obs, axis=0, keepdims=True)
    if obs_var.ndim == 2:
        from jax.scipy.linalg import solve_triangular

        chol = jnp.linalg.cholesky(obs_var)
        perts = solve_triangular(chol, (ens_obs - mean).T, lower=True).T
        innov = solve_triangular(chol, obs_vals - mean[0], lower=True)
        return perts, innov
    rcinv = 1.0 / jnp.sqrt(obs_var)
    perts = (ens_obs - mean) * rcinv
    innov = (obs_vals - mean[0]) * rcinv
    return perts, innov


def _raise_if_overflow(worst: int, max_obs: int) -> None:
    """Loud failure for the window paths' exactness condition (reference
    exactness contract: wrapper.py:91-97)."""
    if worst > max_obs:
        raise ValueError(
            f"a grid column has {worst} in-support (nonzero-taper) "
            f"observations but max_obs={max_obs}: the window selection "
            f"would truncate. Raise max_obs to >= {worst} or pass "
            "max_obs_strict=False to accept truncation to the nearest "
            "observations."
        )


def make_letkf_analysis(
    localization,
    inf_factor: float = 1.0,
    chunksize: Optional[int] = None,
    obs_operator: Optional[Callable] = None,
    method: str = "eigh",
    newton_iters: int = 25,
    max_obs: Optional[int] = None,
    cheb_degree: int = 16,
    selection: str = "topk",
    obs_block: Optional[int] = None,
    max_obs_strict: bool = True,
    geometry: Optional[tuple] = None,
):
    """Build a jitted single-cycle LETKF analysis.

    Parameters
    ----------
    localization : taper object (or None).
    inf_factor : inflation rho.
    chunksize : grid columns per processing chunk (HBM bound).
    obs_operator : optional jnp callable ``[..., grid] -> [..., obs]``; by
        default observations are direct point observations selected by the
        ``obs_idx`` argument.
    method : solver path (see docs/solvers.md):
        ``"eigh"`` — exact eigendecomposition, reference-parity math and the
        differentiation-friendly f64 oracle path;
        ``"newton"`` — matmul-only Newton-Schulz (smooth gradients);
        ``"woodbury"`` — dual-space Newton-Schulz over obs neighborhoods;
        ``"cheb"`` — Chebyshev/Clenshaw solve over gathered neighborhoods
        (needs ``max_obs``);
        ``"fused1d"`` — the whole analysis (window selection + GC taper +
        gather + Chebyshev solve + apply) over sorted-coordinate windows;
        requires sorted 1-D obs coordinates and a single-radius
        GaspariCohn localization. The headline path.
        ``"fused2d"`` — the 2-D window analysis (per-tile y-band obs
        blocks, in-block x-windows, per-dimension product taper); takes the
        first two coordinate columns, any obs order, one or two radii.
    newton_iters : Newton iteration count for the Newton/Woodbury paths.
    max_obs : if set, each grid column solves over only its ``max_obs``
        largest-taper-weight observations (exact whenever no column has more
        nonzero-weight obs than that — see
        :func:`tpu_assim.ops.localization.neighborhood_select`); otherwise
        the weighted Gram runs over the full obs vector.
    cheb_degree : Chebyshev degree for the ``cheb``/``fused1d``/``fused2d``
        paths.
    selection : ``"topk"`` (general) or ``"window"`` (sorted 1-D obs
        coordinates; O(g*nb) instead of O(g*o) + top_k).
    obs_block : explicit per-tile obs block width for ``method="fused2d"``
        (``required_obs_block_2d``). With it set, the returned function is
        fully traceable (usable inside an outer jit, e.g. a cycled scan) —
        otherwise the block is computed host-side from concrete
        coordinates at call time.
    max_obs_strict : enforce the exactness condition of the fixed-size
        window selections loudly — concrete callers raise, traced callers
        NaN-poison, whenever a column has more in-support obs than
        ``max_obs``. False accepts truncation to the nearest
        (see :class:`tpu_assim.interface.LETKF`).
    geometry : optional concrete ``(obs_idx, grid_coords, obs_coords)``
        (``obs_idx`` None with an ``obs_operator``). Binds the obs network
        and grid as XLA constants: the returned function takes only
        ``(state_data, obs_vals, obs_var)`` and the whole selection
        prologue (window starts, band offsets, gather indices) constant-
        folds at compile time — the cycled-DA fast path, where the
        geometry is fixed and only values change per cycle. Host-side
        exactness hardening runs once at build.

    Returns
    -------
    analysis_fn(state_data [k, g], obs_vals [o], obs_var, obs_idx [o],
                grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g]

    ``obs_var`` is either a diagonal variance vector [o] or a full
    correlated covariance [o, o] (Cholesky-whitened inside — the
    reference's ``mul_rcinv`` contract on the fast path).

    The state here is the single-variable single-time ensemble matrix — the
    benchmark layout (reference: examples/benchmark_letkf.py:107-122). For
    the full 4-D state path use :class:`tpu_assim.interface.LETKF`.
    """

    def _select(grid_info, obs_info):
        if selection == "window":
            # exact for sorted 1-D obs coordinates (see
            # neighborhood_select_window); O(g*nb) instead of O(g*o)+top_k
            return neighborhood_select_window(
                localization, grid_info, obs_info, max_obs,
                strict=max_obs_strict,
            )
        return neighborhood_select(localization, grid_info, obs_info, max_obs)

    def _impl(state_data, obs_vals, obs_var, obs_idx, grid_coords,
              obs_coords, obs_block):
        if obs_operator is None:
            ens_obs = jnp.take(state_data, obs_idx, axis=-1)  # [k, o]
        else:
            ens_obs = obs_operator(state_data)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals, obs_var)

        # localization info rows: time column 0 (zero here), then coords
        # (reference prepends analysis time, mixin_local.py:56-58)
        grid_info = jnp.concatenate(
            [jnp.zeros((grid_coords.shape[0], 1), grid_coords.dtype),
             grid_coords], axis=1,
        )
        obs_info = jnp.concatenate(
            [jnp.zeros((obs_coords.shape[0], 1), obs_coords.dtype),
             obs_coords], axis=1,
        )

        if method == "fused1d" and localization is not None and (
            max_obs is not None
        ):
            # The complete analysis over sorted-coordinate windows
            # (selection + GC taper + neighborhood gather + Chebyshev
            # solve + apply) — requires sorted 1-D obs coordinates and a
            # single-radius GaspariCohn taper
            # (ops/window.py:letkf_window_analysis_fused).
            from tpu_assim.ops.localization import GaspariCohnInf
            from tpu_assim.ops.window import (
                letkf_window_analysis_fused,
            )

            if not hasattr(localization, "radius"):
                raise TypeError(
                    "method='fused1d' needs a Gaspari-Cohn localization "
                    "(single radius); got {0}".format(type(localization))
                )
            radius_arr = np.atleast_1d(np.asarray(localization.radius))
            if radius_arr.size != 1:
                raise ValueError(
                    "method='fused1d' supports a single localization "
                    "radius; got {0}".format(radius_arr)
                )
            taper = (
                "gcinf" if isinstance(localization, GaspariCohnInf)
                else "gc2"
            )
            k = state_data.shape[0]
            reg = jnp.asarray((k - 1) / inf_factor, perts.dtype)
            mean = jnp.mean(state_data, axis=0)
            sp = state_data - mean[None, :]
            return letkf_window_analysis_fused(
                perts, innov, obs_coords[:, 0], grid_coords[:, 0], sp,
                mean, reg, float(radius_arr[0]), k,
                nb=max_obs, degree=cheb_degree,
                taper=taper, epsilon=float(localization.epsilon),
                strict=max_obs_strict,
            )

        if method == "fused2d" and localization is not None and (
            max_obs is not None
        ):
            # The complete 2-D analysis: per-tile y-band obs blocks,
            # in-block x-windows, per-dimension product taper
            # (ops/window.py:letkf_window_analysis_fused_2d).
            from tpu_assim.ops.localization import GaspariCohnInf
            from tpu_assim.ops.window import (
                letkf_window_analysis_fused_2d,
            )

            n_dims = min(obs_coords.shape[1], grid_coords.shape[1])
            radii = np.atleast_1d(np.asarray(localization.radius,
                                             dtype=float))
            rx = float(radii[0])
            ry = float(radii[1] if radii.size > 1 else radii[-1])
            extra = tuple(
                float(radii[j] if j < radii.size else radii[-1])
                for j in range(2, n_dims)
            )
            taper = (
                "gcinf" if isinstance(localization, GaspariCohnInf)
                else "gc2"
            )
            k = state_data.shape[0]
            reg = jnp.asarray((k - 1) / inf_factor, perts.dtype)
            mean = jnp.mean(state_data, axis=0)
            sp = state_data - mean[None, :]
            return letkf_window_analysis_fused_2d(
                perts, innov, obs_coords[:, :n_dims],
                grid_coords[:, :n_dims], sp,
                mean, reg, rx, ry, k, obs_block=obs_block,
                nb=max_obs, degree=cheb_degree, taper=taper,
                epsilon=float(localization.epsilon),
                strict=max_obs_strict, extra_radii=extra,
            )

        if method == "cheb" and localization is not None and (
            max_obs is not None
        ):
            # Chebyshev/Clenshaw solve over gathered neighborhoods — the
            # matrix functions are applied to single vectors per column
            # (ops/window.py:letkf_nbh_analysis_cheb).
            from tpu_assim.ops.window import letkf_nbh_analysis_cheb

            k = state_data.shape[0]
            reg = jnp.asarray((k - 1) / inf_factor, perts.dtype)
            mean = jnp.mean(state_data, axis=0)
            sp = state_data - mean[None, :]

            def cheb_chunk(gi_chunk, sp_chunk, mean_chunk):
                from tpu_assim.ops.localization import safe_sqrt

                idx, w_nbh = _select(gi_chunk, obs_info)
                sw = safe_sqrt(w_nbh).astype(perts.dtype)     # [c, nb]
                zh = perts[:, idx].transpose(2, 0, 1) * sw.T[:, None, :]
                yh = innov[idx].T * sw.T                      # [nb, c]
                return letkf_nbh_analysis_cheb(
                    zh, yh, sp_chunk, mean_chunk, reg, k,
                    degree=cheb_degree,
                )

            g = grid_info.shape[0]
            if chunksize is None or chunksize >= g:
                return cheb_chunk(grid_info, sp, mean)
            # sequential lax.map over grid chunks: bounds the gathered
            # neighborhood buffers ([chunk, nb, k]) for very large grids
            # (the reference's dask-chunk analog, letkf.py:121)
            n_chunks = -(-g // chunksize)
            pad = n_chunks * chunksize - g
            gi_p = jnp.pad(grid_info, ((0, pad), (0, 0)))
            sp_p = jnp.pad(sp, ((0, 0), (0, pad)))
            mean_p = jnp.pad(mean, ((0, pad),))
            out = jax.lax.map(
                lambda c: cheb_chunk(
                    gi_p.reshape(n_chunks, chunksize, -1)[c],
                    sp_p.reshape(k, n_chunks, chunksize)[:, c],
                    mean_p.reshape(n_chunks, chunksize)[c],
                ),
                jnp.arange(n_chunks),
            )  # [n_chunks, k, chunksize]
            return out.transpose(1, 0, 2).reshape(k, -1)[:, :g]

        def chunk_fn(g_chunk):
            if localization is not None and max_obs is not None:
                idx, w_nbh = _select(g_chunk, obs_info)
                return letkf_weights_nbh(
                    perts, innov, idx, w_nbh.astype(perts.dtype),
                    jnp.asarray(inf_factor, dtype=perts.dtype),
                    method=method, newton_iters=newton_iters,
                )
            if localization is None:
                w_loc = jnp.ones(
                    (g_chunk.shape[0], obs_info.shape[0]), dtype=perts.dtype
                )
            else:
                w_loc = localization.taper_weights(g_chunk, obs_info).astype(
                    perts.dtype
                )
            return letkf_weights_dense(
                perts, innov, w_loc,
                jnp.asarray(inf_factor, dtype=perts.dtype),
                method=method, newton_iters=newton_iters,
            )

        weights = map_grid_chunked(chunk_fn, grid_info, chunksize)  # [g,k,k]
        mean = jnp.mean(state_data, axis=0, keepdims=True)
        state_perts = state_data - mean
        analysis = mean + jnp.einsum("kg,gkm->mg", state_perts, weights,
                                  precision=jax.lax.Precision.HIGHEST)
        return analysis

    _impl_jit = jax.jit(_impl, static_argnums=(6,))

    def _host_harden(obs_coords_np, grid_coords_np):
        """Host-side hardening for the window paths on concrete
        coordinates: validate sortedness, compute the exact per-tile 2-D
        obs block (required_obs_block_2d — never drops observations,
        whatever the clustering), and enforce the in-support exactness
        condition loudly."""
        blk = obs_block if obs_block is not None else 0
        if obs_block is not None:
            return blk
        if method not in ("fused1d", "fused2d") or localization is None:
            return blk
        from tpu_assim.ops.localization import GaspariCohnInf

        taper_name = (
            "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"
        )
        eps = float(localization.epsilon)
        if method == "fused1d" and max_obs is not None:
            from tpu_assim.ops.window import max_in_support_1d

            ox = obs_coords_np[:, 0]
            if ox.shape[0] > 1 and np.any(ox[1:] < ox[:-1]):
                raise ValueError(
                    "method='fused1d' needs obs coordinates sorted "
                    "ascending along dimension 0"
                )
            radius = float(
                np.atleast_1d(np.asarray(localization.radius, float))[0]
            )
            if max_obs_strict:
                worst = max_in_support_1d(
                    ox, grid_coords_np[:, 0], radius,
                    taper=taper_name, epsilon=eps,
                )
                _raise_if_overflow(worst, max_obs)
        if method == "fused2d" and max_obs is not None:
            from tpu_assim.ops.window import (
                max_in_support_2d,
                required_obs_block_2d,
            )

            radii = np.atleast_1d(np.asarray(localization.radius,
                                             dtype=float))
            rx = float(radii[0])
            ry = float(radii[1] if radii.size > 1 else radii[0])
            blk = required_obs_block_2d(
                obs_coords_np[:, 1], grid_coords_np[:, 1], ry,
            )
            if max_obs_strict:
                worst = max_in_support_2d(
                    obs_coords_np[:, :2], grid_coords_np[:, :2], rx, ry,
                    taper=taper_name, epsilon=eps,
                )
                _raise_if_overflow(worst, max_obs)
        return blk

    if geometry is not None:
        # Static-geometry binding (cycled DA: the obs network and grid are
        # fixed across cycles while values change every cycle): the
        # coordinates and indices become XLA CONSTANTS in the trace, so
        # the whole selection prologue — tile extents, searchsorted block
        # offsets, gather indices, degree-independent index arithmetic —
        # constant-folds at compile time and each cycle pays solve time
        # only. Host-side hardening runs once, here.
        g_idx, g_grid, g_obs = geometry
        g_grid = np.asarray(g_grid)
        g_obs = np.asarray(g_obs)
        blk_static = _host_harden(g_obs, g_grid)
        # numpy (NOT jnp) constants: a device-resident closure constant is
        # copied back to the host at trace time to become an HLO constant
        const_args = (
            np.asarray(g_idx) if g_idx is not None else None,
            g_grid,
            g_obs,
        )

        @jax.jit
        def analysis_fn_static(state_data, obs_vals, obs_var):
            return _impl(state_data, obs_vals, obs_var, const_args[0],
                         const_args[1], const_args[2], blk_static)

        return analysis_fn_static

    def analysis_fn(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords):
        # Host-side hardening whenever the coordinates are concrete
        # (direct calls). Under an outer jit the coordinates are tracers;
        # the 1-D path then NaN-poisons any overflowing column instead of
        # being silently wrong, while fused2d requires a precomputed block.
        concrete = not isinstance(
            obs_coords, jax.core.Tracer
        ) and not isinstance(grid_coords, jax.core.Tracer)
        if obs_block is None and not concrete:
            if method == "fused2d" and localization is not None and (
                max_obs is not None
            ):
                raise ValueError(
                    "method='fused2d' under an outer jit needs the per-tile "
                    "obs block precomputed: build the analysis with "
                    "make_letkf_analysis(..., obs_block="
                    "required_obs_block_2d(...)) — or bind the geometry "
                    "(make_letkf_analysis(..., geometry=(obs_idx, "
                    "grid_coords, obs_coords)))"
                )
            blk = 0
        else:
            blk = _host_harden(
                np.asarray(obs_coords) if concrete else None,
                np.asarray(grid_coords) if concrete else None,
            ) if concrete else (obs_block if obs_block is not None else 0)
        return _impl_jit(state_data, obs_vals, obs_var, obs_idx,
                         grid_coords, obs_coords, blk)

    return analysis_fn


def make_strip_letkf_2d(
    localization,
    geometry: tuple,
    n_strips: int,
    inf_factor: float = 1.0,
    max_obs: Optional[int] = None,
    cheb_degree: int = 16,
    max_obs_strict: bool = True,
    tile: int = 128,
):
    """Production-scale 2-D LETKF: x-strip domain decomposition over the
    2-D window analysis, static geometry.

    The fused2d per-tile candidate band spans the tile's y-range over the
    WHOLE domain width, so its selection cost grows linearly with the
    grid's x extent (docs/solvers.md §6). For wide production grids
    (e.g. 1024 x 1024) this builder splits the domain into ``n_strips``
    x-strips, runs the window analysis per strip over only the strip's
    observations (plus the taper-support overlap — the single-chip analog
    of the halo decomposition, parallel/halo.py), and scatters the strips
    back. Exact: every strip sees all observations inside its columns'
    taper support; strict in-support checks run per strip at build.

    Parameters
    ----------
    geometry : concrete ``(obs_cells, grid_xy, obs_xy)`` — flat observed
        cell index [o], grid coordinates [g, 2] (row-major, integer-like x
        in column 0), obs coordinates [o, 2]. Static across calls; baked
        as XLA constants (the cycled-DA setting).
    n_strips : number of x-strips. All strip shapes are identical, so all
        strips run as one batched program over one shared obs table.
    max_obs : window size; None (default) = auto: the exact worst
        per-column slot consumption measured under the strip tiling
        (rounded up to a multiple of 4).

    Returns ``fn(state_data [k, g], obs_vals [o], obs_var [o]) -> [k, g]``.
    """
    plan = _strip_plan_2d(localization, geometry[1], geometry[2], n_strips,
                          max_obs, max_obs_strict, tile)
    cells_c = np.asarray(geometry[0]).astype(np.int32)

    @jax.jit
    def analysis_fn(state_data, obs_vals, obs_var):
        k = state_data.shape[0]
        ens_obs = jnp.take(state_data, cells_c, axis=-1)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals, obs_var)
        mean = jnp.mean(state_data, axis=0)
        sp = state_data - mean[None, :]
        reg = jnp.asarray((k - 1) / inf_factor, jnp.float32)
        out = _strip_apply_2d(plan, perts, innov, sp[None], mean[None],
                              reg, cheb_degree)
        return out[0].astype(state_data.dtype)

    return analysis_fn


def _strip_plan_2d(localization, grid_xy, obs_xy, n_strips,
                   max_obs, max_obs_strict, tile: int = 128):
    """Host-side x-strip decomposition plan from CONCRETE 2-D geometry
    (shared by :func:`make_strip_letkf_2d` and the class API's
    ``LETKF(method="fused2d")`` auto-strips): per-strip column order +
    scatter-back, the multi-segment y-sorted obs table layout, and the
    per-tile band offsets. All returned arrays are NUMPY — a jnp.asarray
    here would live on the device, and jit tracing would then copy every
    one back to the host to embed it as an HLO constant."""
    from tpu_assim.ops.localization import GaspariCohnInf, taper_support_z
    from tpu_assim.ops.window import max_in_support_2d

    gxy = np.asarray(grid_xy, dtype=np.float32)
    oxy = np.asarray(obs_xy, dtype=np.float32)
    g = gxy.shape[0]
    radii = np.atleast_1d(np.asarray(localization.radius, dtype=float))
    rx = float(radii[0])
    ry = float(radii[1] if radii.size > 1 else radii[0])
    taper = "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"
    eps = float(localization.epsilon)
    cut = taper_support_z(taper, eps) * rx

    gx, gy = gxy[:, 0], gxy[:, 1]
    bounds = np.linspace(gx.min(), gx.max() + 1e-6, n_strips + 1)
    strip_of = np.clip(
        np.searchsorted(bounds, gx, side="right") - 1, 0, n_strips - 1
    )
    cell_idx = []
    gs = 0
    for s in range(n_strips):
        idx = np.nonzero(strip_of == s)[0]
        # row-major order inside the strip (thin per-tile y-bands)
        idx = idx[np.lexsort((gx[idx], gy[idx]))]
        cell_idx.append(idx)
        gs = max(gs, idx.shape[0])
    gs = -(-gs // tile) * tile
    # pad ragged strips by repeating their first cell — the duplicate
    # column's analysis equals the real one and the scatter-back simply
    # rewrites it
    cell_idx = [
        np.concatenate([idx, np.full(gs - len(idx), idx[0], idx.dtype)])
        if len(idx) < gs else idx
        for idx in cell_idx
    ]

    # per-strip obs: everything inside the strip's x-support window
    ox = oxy[:, 0]
    sel, p = [], 0
    for s in range(n_strips):
        lo = gx[cell_idx[s]].min() - cut
        hi = gx[cell_idx[s]].max() + cut
        sel.append(np.nonzero((ox > lo) & (ox < hi))[0])
        p = max(p, sel[-1].shape[0])
    p = max(p, 1)
    big = np.float32(np.finfo(np.float32).max)
    worst = 0
    if max_obs_strict or max_obs is None:
        for s in range(n_strips):
            worst = max(worst, max_in_support_2d(
                oxy[sel[s]], gxy[cell_idx[s]], rx, ry, taper=taper,
                epsilon=eps, tile=tile))
    if max_obs is None:
        # auto: the exact worst per-column slot consumption under THIS
        # strip tiling (taller strip tiles see wider y-bands than the
        # global tiling, so a globally-sized window can overflow here)
        max_obs = max(-(-worst // 4) * 4, 8)
    elif max_obs_strict:
        _raise_if_overflow(worst, max_obs)

    # All strips share one multi-segment obs table ([n_strips * p] slots,
    # each segment y-sorted with pad slots last) and run as one batched
    # program. Band offsets are computed HOST-SIDE here from the static
    # geometry: per-tile constants, nothing to fold or check at compile
    # time.
    ord_sel = np.zeros((n_strips, p), dtype=np.int64)
    seg_valid = np.zeros((n_strips, p), dtype=np.float32)
    seg_ox = np.full((n_strips, p), big, dtype=np.float32)
    seg_oy = np.full((n_strips, p), big, dtype=np.float32)
    for s in range(n_strips):
        n_s = sel[s].shape[0]
        ys = np.argsort(oxy[sel[s], 1], kind="stable")
        ord_sel[s, :n_s] = sel[s][ys]
        seg_valid[s, :n_s] = 1.0
        seg_ox[s, :n_s] = oxy[sel[s][ys], 0]
        seg_oy[s, :n_s] = oxy[sel[s][ys], 1]

    # per-tile bands in the flat [n_strips * p] table (host-side mirror of
    # the fused2d prologue: band = [min(gy) - 2ry, max(gy) + 2ry] within the
    # tile's own strip segment): (block offset, band start, band end), the
    # last two relative to the offset
    tiles_per_strip = gs // tile
    n_tiles = n_strips * tiles_per_strip
    iy0 = np.zeros(n_tiles, dtype=np.int64)
    iy1 = np.zeros(n_tiles, dtype=np.int64)
    for s in range(n_strips):
        ty = gy[cell_idx[s]].reshape(tiles_per_strip, tile)
        t0 = s * tiles_per_strip
        iy0[t0:t0 + tiles_per_strip] = np.searchsorted(
            seg_oy[s], ty.min(axis=1) - 2.0 * ry)
        iy1[t0:t0 + tiles_per_strip] = np.searchsorted(
            seg_oy[s], ty.max(axis=1) + 2.0 * ry, side="right")
    o_bd = int(max(int((iy1 - iy0).max()) if n_tiles else 1, 1))
    # blocks stay inside their segment: tiles near a segment's top shift
    # their offset down instead
    off = np.clip(iy0, 0, p - o_bd)
    seg0 = np.repeat(np.arange(n_strips) * p, tiles_per_strip)
    bands = np.stack([seg0 + off, iy0 - off, iy1 - off], axis=1)

    # gather-based scatter-back: for every original cell, one position in
    # the strip concat (duplicate pad cells resolve to their real copy)
    perm = np.concatenate(cell_idx)
    inv = np.zeros(g, dtype=np.int64)
    inv[perm] = np.arange(perm.shape[0])

    return {
        "osel": ord_sel.reshape(-1).astype(np.int32),
        "oval": seg_valid.reshape(-1),
        "seg_ox": seg_ox.reshape(-1),
        "seg_oy": seg_oy.reshape(-1),
        "bands": bands.astype(np.int32),              # [n_tiles, 3]
        "o_bd": o_bd,
        "perm": perm.astype(np.int32),
        "inv": inv.astype(np.int32),
        "grid2": np.stack([gx[perm], gy[perm]], axis=0),
        "max_obs": int(max_obs),
        "rx": rx, "ry": ry, "taper": taper, "eps": eps,
        "strict": bool(max_obs_strict), "tile": int(tile),
    }


def _strip_apply_2d(plan, perts, innov, sp, mean, reg, cheb_degree):
    """Run the strip plan's banded 2-D window analysis over
    R^{-1/2}-normalized obs-space arrays (``perts [k, o]``, ``innov [o]``)
    and multi-slice state (``sp [ns, k, g]``, ``mean [ns, g]``). Returns
    the analysis [ns, k, g] in original column order."""
    from tpu_assim.ops.window import _window2d_tiles

    f32 = jnp.float32
    k = perts.shape[0]
    p_flat = jnp.take(perts, plan["osel"], axis=-1) * plan["oval"][None, :]
    i_flat = jnp.take(innov, plan["osel"]) * plan["oval"]
    table = jnp.concatenate(
        [p_flat, i_flat[None, :], plan["seg_ox"][None, :],
         plan["seg_oy"][None, :]], axis=0,
    ).astype(f32)                                       # [k+3, S*p]
    sp_all = jnp.take(sp, plan["perm"], axis=-1).astype(f32)
    mean3 = jnp.take(mean, plan["perm"], axis=-1).astype(f32)[:, None, :]
    scal = jnp.stack([reg.astype(f32), jnp.asarray(plan["rx"], f32),
                      jnp.asarray(plan["ry"], f32)])
    out = _window2d_tiles(
        table, jnp.asarray(plan["bands"]), plan["o_bd"],
        jnp.asarray(plan["grid2"], f32), sp_all, mean3, scal,
        ens_size=k, nb=plan["max_obs"], degree=cheb_degree,
        epsilon=plan["eps"], taper=plan["taper"], strict=plan["strict"],
        tile=plan["tile"],
    )                                                   # [ns, k, S*gs]
    return jnp.take(out, plan["inv"], axis=-1)


def make_etkf_analysis(inf_factor: float = 1.0,
                       obs_operator: Optional[Callable] = None):
    """Build a jitted global-ETKF analysis with the same signature as
    :func:`make_letkf_analysis` (grid/obs coords ignored)."""

    @jax.jit
    def analysis_fn(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords):
        if obs_operator is None:
            ens_obs = jnp.take(state_data, obs_idx, axis=-1)
        else:
            ens_obs = obs_operator(state_data)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals, obs_var)
        weights = etkf_weights(
            perts, innov[None, :], jnp.asarray(inf_factor, dtype=perts.dtype)
        )
        mean = jnp.mean(state_data, axis=0, keepdims=True)
        state_perts = state_data - mean
        analysis = mean + jnp.einsum("kg,km->mg", state_perts, weights,
                                  precision=jax.lax.Precision.HIGHEST)
        return analysis

    return analysis_fn


def make_cycle_step(
    integrator,
    n_int_steps: int,
    localization,
    inf_factor: float = 1.0,
    chunksize: Optional[int] = None,
    **analysis_opts,
):
    """Build a jitted forecast+analysis cycle step for a [k, g] ensemble:
    integrate every member ``n_int_steps`` steps, then run the LETKF analysis
    — the composition the reference's cycled experiments build by hand
    (SURVEY §3.5; examples/benchmark_letkf.py + RK4Integrator).

    ``analysis_opts`` pass through to :func:`make_letkf_analysis`
    (method / max_obs / selection / cheb_degree / geometry). With
    ``geometry=(obs_idx, grid_coords, obs_coords)`` (concrete — the cycled
    setting, where the obs network is fixed) the returned step takes only
    ``(state_data, obs_vals, obs_var)`` and the analysis prologue is
    constant-folded at compile time.

    Returns step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                 obs_coords) -> analysis [k, g] (first three args only
    when ``geometry`` is bound).
    """
    analyse = make_letkf_analysis(localization, inf_factor, chunksize,
                                  **analysis_opts)

    def _forecast(state_data):
        def body(s, _):
            return integrator.integrate(s), None

        forecast, _ = jax.lax.scan(body, state_data, None,
                                   length=n_int_steps)
        return forecast

    if analysis_opts.get("geometry") is not None:
        @jax.jit
        def step_static(state_data, obs_vals, obs_var):
            return analyse(_forecast(state_data), obs_vals, obs_var)

        return step_static

    @jax.jit
    def step(state_data, obs_vals, obs_var, obs_idx, grid_coords, obs_coords):
        return analyse(
            _forecast(state_data), obs_vals, obs_var, obs_idx, grid_coords,
            obs_coords
        )

    return step


def make_lienks_step(
    localization,
    integrator,
    n_int_steps: int,
    n_outer: int = 3,
    kind: str = "transform",
    tau: float = 1.0,
    epsilon: float = 1e-4,
    max_obs: Optional[int] = None,
    selection: str = "window",
    max_obs_strict: bool = True,
    obs_operator: Optional[Callable] = None,
):
    """Build a jitted localized-IEnKS analysis (the 4D-Var-shaped
    smoother) for a [k, g] ensemble over a fixed assimilation window.

    Per outer iteration (the composition the reference's VarAssimilation
    template drives host-side, /root/reference/pytassim/interface/
    variational.py:89-135 + lienks.py:68-118): apply the current
    per-column weights to the prior ensemble, propagate the weighted
    ensemble ``n_int_steps`` model steps, apply the obs operator, compute
    R^{-1/2}-normalized obs-space statistics, and run one localized
    Gauss-Newton inner step per grid column
    (:func:`tpu_assim.ops.ienks.ienks_transform_step` /
    ``ienks_bundle_step``, batched [g, k, k]). The whole ``n_outer``-
    iteration loop is ONE jitted XLA program; each inner step's per-column
    K x K factorisations are one batched LU inverse and one batched
    ``eigh`` (:func:`tpu_assim.ops.linalg.eigh_psd`).

    The obs-network geometry is fixed across iterations, so the
    neighborhood selection and taper weights are computed once and
    reused (bitwise-identical to recomputing: the coordinates do not
    change inside the window).

    Parameters
    ----------
    localization : Gaspari-Cohn taper (or None for global).
    integrator / n_int_steps : forward model for the window (e.g.
        ``RK4Integrator(Lorenz96(), dt)``); None skips propagation
        (3D / filter configuration).
    kind : ``"transform"`` (dH/dW through the inverted weight
        perturbations) or ``"bundle"`` (finite-difference scale
        ``epsilon``) — reference core/ienks.py:71-77 vs :168-174.
    max_obs / selection / max_obs_strict : fixed-size neighborhood
        selection, as in :func:`make_letkf_analysis`.

    Returns
    -------
    step(state_data [k, g], obs_vals [o], obs_var [o], obs_idx [o],
         grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g]
    """
    from tpu_assim.ops.ienks import ienks_bundle_step, ienks_transform_step
    from tpu_assim.ops.localization import safe_sqrt

    if kind not in ("transform", "bundle"):
        raise ValueError(f"kind must be 'transform' or 'bundle', got {kind!r}")

    def _forward(state_data):
        if integrator is None or n_int_steps == 0:
            return state_data
        def body(s, _):
            return integrator.integrate(s), None

        out, _ = jax.lax.scan(body, state_data, None, length=n_int_steps)
        return out

    @jax.jit
    def step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
             obs_coords):
        k, g = state_data.shape
        mean = jnp.mean(state_data, axis=0)
        perts = state_data - mean[None, :]                     # [k, g]

        grid_info = jnp.concatenate(
            [jnp.zeros((grid_coords.shape[0], 1), grid_coords.dtype),
             grid_coords], axis=1,
        )
        obs_info = jnp.concatenate(
            [jnp.zeros((obs_coords.shape[0], 1), obs_coords.dtype),
             obs_coords], axis=1,
        )
        if localization is not None and max_obs is not None:
            if selection == "window":
                idx, w_nbh = neighborhood_select_window(
                    localization, grid_info, obs_info, max_obs,
                    strict=max_obs_strict,
                )
            else:
                idx, w_nbh = neighborhood_select(
                    localization, grid_info, obs_info, max_obs
                )
            sqrt_w = safe_sqrt(w_nbh).astype(state_data.dtype)  # [g, nb]
        else:
            idx = None
            if localization is None:
                w_loc = jnp.ones((g, obs_info.shape[0]), state_data.dtype)
            else:
                w_loc = localization.taper_weights(
                    grid_info, obs_info
                ).astype(state_data.dtype)
            sqrt_w = safe_sqrt(w_loc)                           # [g, o]

        eye = jnp.eye(k, dtype=state_data.dtype)
        weights = jnp.broadcast_to(eye, (g, k, k))
        tau_a = jnp.asarray(tau, state_data.dtype)
        eps_a = jnp.asarray(epsilon, state_data.dtype)

        for _ in range(n_outer):
            if kind == "bundle":
                # bundle propagates with eps*I + mean(W)
                # (reference: ienks.py:157-164)
                w_model = eps_a * eye + jnp.mean(weights, axis=-1,
                                                 keepdims=True)
            else:
                w_model = weights
            pseudo = mean[None, :] + jnp.einsum(
                "kg,gkm->mg", perts, w_model,
                precision=jax.lax.Precision.HIGHEST,
            )
            pseudo = _forward(pseudo)
            if obs_operator is None:
                ens_obs = jnp.take(pseudo, obs_idx, axis=-1)    # [k, o]
            else:
                ens_obs = obs_operator(pseudo)
            perts_o, innov = _normalized_obs_space(ens_obs, obs_vals,
                                                   obs_var)
            if idx is not None:
                scaled_perts = (
                    perts_o[:, idx].transpose(1, 0, 2) * sqrt_w[:, None, :]
                )                                               # [g, k, nb]
                scaled_obs = (innov[idx] * sqrt_w)[:, None, :]
            else:
                scaled_perts = perts_o[None, :, :] * sqrt_w[:, None, :]
                scaled_obs = (innov[None, :] * sqrt_w)[:, None, :]
            if kind == "bundle":
                weights = ienks_bundle_step(
                    weights, scaled_perts, scaled_obs, tau_a, eps_a
                )
            else:
                weights = ienks_transform_step(
                    weights, scaled_perts, scaled_obs, tau_a
                )

        return mean[None, :] + jnp.einsum(
            "kg,gkm->mg", perts, weights,
            precision=jax.lax.Precision.HIGHEST,
        )

    return step
