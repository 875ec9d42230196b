"""
Domain localization: Gaspari-Cohn taper functions.

JAX rebuild of /root/reference/pytassim/localization/gaspari_cohn.py:
the piecewise-quintic correlation polynomials are kept verbatim (they define
the algorithm), but the evaluation is a fully-traced, branch-free ``jnp.where``
chain that evaluates all grid columns against all observations in one batched
call — replacing the reference's per-gridpoint numpy masking
(gaspari_cohn.py:97-136) which produced ragged obs subsets.

Localization weights below ``epsilon`` are cut to exactly zero; zero-weight
observations contribute nothing to the weighted Gram products in
:func:`tpu_assim.ops.etkf.letkf_weights_dense`, so the fixed-size masked
formulation is *exactly* equivalent to the reference's ragged subsets.

Distance functions are user-supplied jnp callables
``dist_func(grid_coord [d], obs_coords [o, d]) -> [n_dim, o] or [o]``
(the reference takes the same user callable, gaspari_cohn.py:55-58).
"""

from typing import Callable, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BaseLocalization",
    "GaspariCohn",
    "GaspariCohnInf",
    "abs_distance",
    "neighborhood_select",
    "neighborhood_select_window",
    "periodic_distance",
    "safe_sqrt",
]


def safe_sqrt(w: jnp.ndarray) -> jnp.ndarray:
    """``sqrt`` with a zero (not inf/NaN) gradient at ``w == 0``.

    Taper weights are exactly zero outside the localization support; plain
    ``jnp.sqrt``'s derivative is infinite there, which turns every padded
    neighborhood slot into NaN cotangents under reverse-mode AD. Primal
    values are identical to ``jnp.sqrt`` for ``w >= 0``.
    """
    w_safe = jnp.where(w > 0, w, 1.0)
    return jnp.where(w > 0, jnp.sqrt(w_safe), 0.0)


def abs_distance(grid_coord: jnp.ndarray, obs_coords: jnp.ndarray) -> jnp.ndarray:
    """Per-dimension absolute difference (the distance the reference
    benchmarks use, examples/benchmark_letkf.py:85-87)."""
    grid_coord = jnp.atleast_1d(grid_coord)
    obs_coords = jnp.atleast_2d(obs_coords)
    return jnp.abs(obs_coords - grid_coord[None, :]).T


def periodic_distance(period: float) -> Callable:
    """Per-dimension distance on a ring of given period (for Lorenz-96
    grids)."""

    def dist(grid_coord: jnp.ndarray, obs_coords: jnp.ndarray) -> jnp.ndarray:
        grid_coord = jnp.atleast_1d(grid_coord)
        obs_coords = jnp.atleast_2d(obs_coords)
        d = jnp.abs(obs_coords - grid_coord[None, :]).T
        return jnp.minimum(d, period - d)

    return dist


class BaseLocalization:
    """Base localization API (reference:
    pytassim/localization/localization.py:40-80)."""

    def localize_obs(
        self, grid_coord: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Return ``(use_obs, weights)`` for one grid column: a boolean mask
        of usable observations and their taper weights."""
        raise NotImplementedError

    def localize_cov(self):
        """Covariance localization — declared but never implemented by the
        reference either (localization.py:45-52)."""
        raise NotImplementedError

    def taper_weights(
        self, grid_coords: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> jnp.ndarray:
        """Batched taper: weights for every (grid column, obs) pair with
        sub-epsilon weights cut to exactly zero.

        Parameters
        ----------
        grid_coords : [g, d] coordinates of the grid columns.
        obs_coords : [o, d] coordinates of the observations.

        Returns
        -------
        weights : [g, o]
        """

        def one_column(coord):
            use_obs, weights = self.localize_obs(coord, obs_coords)
            return jnp.where(use_obs, weights, 0.0)

        return jax.vmap(one_column)(grid_coords)


class GaspariCohn(BaseLocalization):
    """Gaspari-Cohn correlation function ``C_0(z, 1/2, c)``
    (reference: pytassim/localization/gaspari_cohn.py:41-136).

    Per-dimension radii are multiplied together; the function is truncated to
    zero at ``2 * length_scale``.

    Parameters
    ----------
    length_scale : scalar or sequence of per-dimension radii ``c``.
    dist_func : callable ``(grid_coord, obs_coords) -> [n_dim, o]`` distances.
    epsilon : weights below this value are masked out.
    """

    def __init__(
        self,
        length_scale: Union[float, Tuple[float, ...]],
        dist_func: Callable,
        epsilon: float = 1e-5,
    ):
        self.radius = np.atleast_1d(np.asarray(length_scale, dtype=np.float64))
        self.dist_func = dist_func
        self.epsilon = epsilon

    def __str__(self) -> str:
        return "GaspariCohn(l={0})".format(str(self.radius))

    @staticmethod
    def _f1(z: jnp.ndarray) -> jnp.ndarray:
        """Inner segment, z < 1 (reference: gaspari_cohn.py:77-84)."""
        return -0.25 * z**5 + 0.5 * z**4 + 0.625 * z**3 - 5.0 / 3.0 * z**2 + 1.0

    @staticmethod
    def _f2(z: jnp.ndarray) -> jnp.ndarray:
        """Outer segment, 1 <= z < 2 (reference: gaspari_cohn.py:86-95)."""
        return (
            1.0 / 12.0 * z**5
            - 0.5 * z**4
            + 0.625 * z**3
            + 5.0 / 3.0 * z**2
            - 5.0 * z
            + 4.0
            - 2.0 / 3.0 / z
        )

    def localize_obs(
        self, grid_coord: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        dist = jnp.atleast_2d(self.dist_func(grid_coord, obs_coords))
        n_dim = dist.shape[0]
        weights = jnp.ones(dist.shape[1], dtype=dist.dtype)
        for i in range(n_dim):
            radius = self.radius[i] if i < len(self.radius) else self.radius[-1]
            z = dist[i] / radius
            z_safe = jnp.maximum(z, 0.5)   # see taper_from_dist
            w = jnp.where(z < 2.0, self._f2(z_safe), 0.0)
            w = jnp.where(z < 1.0, self._f1(z), w)
            weights = weights * w
        use_obs = weights > self.epsilon
        return use_obs, weights

    def taper_from_dist(self, dist: jnp.ndarray) -> jnp.ndarray:
        """Apply the GC polynomials to precomputed per-dimension distances
        ``[..., n_dim, m]`` -> weights ``[..., m]`` (sub-epsilon cut to 0)."""
        n_dim = dist.shape[-2]
        weights = jnp.ones(dist.shape[:-2] + dist.shape[-1:], dtype=dist.dtype)
        for i in range(n_dim):
            radius = self.radius[i] if i < len(self.radius) else self.radius[-1]
            z = dist[..., i, :] / radius
            # clamp the out-of-branch argument into f2's domain: the 1/z term
            # would otherwise produce inf value AND derivative at z ~ 0,
            # poisoning reverse-mode AD through the selecting where (0 * inf)
            z_safe = jnp.maximum(z, 0.5)
            w = jnp.where(z < 2.0, self._f2(z_safe), 0.0)
            w = jnp.where(z < 1.0, self._f1(z), w)
            weights = weights * w
        return jnp.where(weights > self.epsilon, weights, 0.0)

    def taper_weights(
        self, grid_coords: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> jnp.ndarray:
        # Flat batched evaluation: vmap only the user distance function, then
        # run the piecewise polynomials on the whole [g, o] matrix at once.
        # (vmapping the polynomial chain per column lowers to a ~35x slower
        # program — the [1, o]-shaped where-chains defeat fusion.)
        # Subclasses overriding localize_obs get the generic per-column path.
        if type(self).localize_obs is not GaspariCohn.localize_obs:
            return BaseLocalization.taper_weights(self, grid_coords, obs_coords)
        dist = jax.vmap(
            lambda gc: jnp.atleast_2d(self.dist_func(gc, obs_coords))
        )(grid_coords)  # [g, n_dim, o]
        return self.taper_from_dist(dist)


class GaspariCohnInf(BaseLocalization):
    """Gaspari-Cohn correlation function ``C_0(z, inf, c)`` with four
    piecewise segments (reference: pytassim/localization/gaspari_cohn.py:139-254).
    """

    def __init__(
        self,
        length_scale: float,
        dist_func: Callable,
        epsilon: float = 1e-5,
    ):
        self.radius = float(length_scale)
        self.dist_func = dist_func
        self.epsilon = epsilon

    def __str__(self) -> str:
        return "GaspariCohnInf(l={0})".format(str(self.radius))

    @staticmethod
    def _f1(z: jnp.ndarray) -> jnp.ndarray:
        """z < 0.5 (reference: gaspari_cohn.py:175-182)."""
        return (
            -28.0 * z**5 / 33.0
            + 8.0 * z**4 / 11.0
            + 20.0 * z**3 / 11.0
            - 80.0 * z**2 / 33.0
            + 1.0
        )

    @staticmethod
    def _f2(z: jnp.ndarray) -> jnp.ndarray:
        """0.5 <= z < 1 (reference: gaspari_cohn.py:184-192)."""
        return (
            20.0 * z**5 / 33.0
            - 16.0 * z**4 / 11.0
            + 100.0 * z**2 / 33.0
            - 45.0 * z / 11.0
            + 51.0 / 22.0
            - 7.0 / (44.0 * z)
        )

    @staticmethod
    def _f3(z: jnp.ndarray) -> jnp.ndarray:
        """1 <= z < 1.5 (reference: gaspari_cohn.py:194-203)."""
        return (
            -4.0 * z**5 / 11.0
            + 16.0 * z**4 / 11.0
            - 10.0 * z**3 / 11.0
            - 100.0 * z**2 / 33.0
            + 5.0 * z
            - 61.0 / 22.0
            + 115.0 / (132.0 * z)
        )

    @staticmethod
    def _f4(z: jnp.ndarray) -> jnp.ndarray:
        """1.5 <= z < 2 (reference: gaspari_cohn.py:205-214)."""
        return (
            4.0 * z**5 / 33.0
            - 8.0 * z**4 / 11.0
            + 10.0 * z**3 / 11.0
            + 80.0 * z**2 / 33.0
            - 80.0 * z / 11.0
            + 64.0 / 11.0
            - 32.0 / (33.0 * z)
        )

    def localize_obs(
        self, grid_coord: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        dist = jnp.asarray(self.dist_func(grid_coord, obs_coords)).reshape(-1)
        z = dist / self.radius
        z_safe = jnp.maximum(z, 0.25)      # see GaspariCohn.taper_from_dist
        weights = jnp.where(z < 2.0, self._f4(z_safe), 0.0)
        weights = jnp.where(z < 1.5, self._f3(z_safe), weights)
        weights = jnp.where(z < 1.0, self._f2(z_safe), weights)
        weights = jnp.where(z < 0.5, self._f1(z), weights)
        use_obs = weights > self.epsilon
        return use_obs, weights

    def taper_from_dist(self, dist: jnp.ndarray) -> jnp.ndarray:
        """Apply the GC(z, inf, c) polynomials to precomputed distances
        ``[..., n_dim, m]`` (single-dim radius: dims are multiplied after
        per-dim evaluation for API parity with GaspariCohn)."""
        weights = jnp.ones(dist.shape[:-2] + dist.shape[-1:], dtype=dist.dtype)
        for i in range(dist.shape[-2]):
            z = dist[..., i, :] / self.radius
            z_safe = jnp.maximum(z, 0.25)  # see GaspariCohn.taper_from_dist
            w = jnp.where(z < 2.0, self._f4(z_safe), 0.0)
            w = jnp.where(z < 1.5, self._f3(z_safe), w)
            w = jnp.where(z < 1.0, self._f2(z_safe), w)
            w = jnp.where(z < 0.5, self._f1(z), w)
            weights = weights * w
        return jnp.where(weights > self.epsilon, weights, 0.0)

    def taper_weights(
        self, grid_coords: jnp.ndarray, obs_coords: jnp.ndarray
    ) -> jnp.ndarray:
        # Flat batched evaluation (see GaspariCohn.taper_weights).
        if type(self).localize_obs is not GaspariCohnInf.localize_obs:
            return BaseLocalization.taper_weights(self, grid_coords, obs_coords)
        dist = jax.vmap(
            lambda gc: jnp.asarray(self.dist_func(gc, obs_coords)).reshape(-1)
        )(grid_coords)  # [g, o]
        return self.taper_from_dist(dist[:, None, :])


def taper_support_z(taper: str = "gc2", epsilon: float = 1e-5) -> float:
    """Normalized-distance support bound of the Gaspari-Cohn tapers with the
    sub-``epsilon`` cut applied: the largest ``z = dist / radius`` with
    ``w(z) > epsilon`` (host-side bisection; both GC variants are monotone
    decreasing on [0, 2] and exactly zero beyond — reference truncation:
    pytassim/localization/gaspari_cohn.py:124-136).

    Used by the exactness guards of the window kernels: an observation can
    contribute to a column only if its normalized distance is < this bound.
    """
    if epsilon <= 0.0:
        return 2.0

    if taper == "gc2":
        def w(z):
            if z < 1.0:
                return float(GaspariCohn._f1(z))
            if z < 2.0:
                return float(GaspariCohn._f2(z))
            return 0.0
    elif taper == "gcinf":
        def w(z):
            if z < 0.5:
                return float(GaspariCohnInf._f1(z))
            if z < 1.0:
                return float(GaspariCohnInf._f2(z))
            if z < 1.5:
                return float(GaspariCohnInf._f3(z))
            if z < 2.0:
                return float(GaspariCohnInf._f4(z))
            return 0.0
    else:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    if w(0.0) <= epsilon:
        return 0.0
    lo, hi = 0.0, 2.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if w(mid) > epsilon:
            lo = mid
        else:
            hi = mid
    # the upper end of the bracket: boundary-shell obs count as in-support
    # (conservative by < 1e-17 in z)
    return hi


def neighborhood_select(
    localization,
    grid_coords: jnp.ndarray,
    obs_coords: jnp.ndarray,
    max_obs: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-size obs neighborhoods: the ``max_obs`` highest-taper-weight
    observations per grid column.

    The reference handles localization with *ragged* per-gridpoint obs
    subsets (pytassim/interface/wrapper.py:91-97) — impossible under XLA's
    static shapes and wasteful on the device. Instead each column gets a static
    ``max_obs``-sized neighborhood chosen by ``top_k`` of the taper weights.
    When every column has at most ``max_obs`` observations with nonzero
    taper weight (for Gaspari-Cohn: all obs within ``2 * radius``), the
    padded entries carry weight exactly 0 and contribute nothing to the
    weighted Gram products — the selection is then *exact*, not an
    approximation; otherwise it truncates to the ``max_obs`` closest
    (largest-weight) observations, the standard LETKF practice for bounding
    local obs counts.

    Returns ``(idx [g, max_obs] int32, weights [g, max_obs])``.
    """
    weights = localization.taper_weights(grid_coords, obs_coords)  # [g, o]
    n_obs = weights.shape[-1]
    k = min(max_obs, n_obs)
    top_w, top_idx = jax.lax.top_k(weights, k)
    if k < max_obs:  # fewer obs than the neighborhood size: zero-pad
        pad = max_obs - k
        top_w = jnp.pad(top_w, ((0, 0), (0, pad)))
        top_idx = jnp.pad(top_idx, ((0, 0), (0, pad)))
    return top_idx.astype(jnp.int32), top_w


def neighborhood_select_window(
    localization,
    grid_coords: jnp.ndarray,
    obs_coords: jnp.ndarray,
    max_obs: int,
    coord_col: int = 1,
    strict: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-size obs neighborhoods by sorted-coordinate window — the exact
    fast path for 1-D domains.

    Requires the observations sorted by the localization coordinate
    (column ``coord_col`` of ``obs_coords``) and a taper monotone in
    ``|x - y|`` along that single coordinate. Then the ``max_obs``
    coordinate-nearest observations form a contiguous window around each
    column's ``searchsorted`` insertion point, and they are exactly the
    ``max_obs`` largest-taper-weight observations — the same result as
    :func:`neighborhood_select`, at O(g * max_obs) taper cost instead of
    O(g * o) + top_k.

    ``localization`` must expose ``taper_from_dist`` and ``dist_func``
    (both Gaspari-Cohn classes do).

    For single-radius Gaspari-Cohn localizations the rank-centered window
    is additionally clamped onto the column's in-support index range
    (exact for asymmetric in-support distributions too), and with
    ``strict=True`` (default) any column with more than ``max_obs``
    in-support observations gets NaN weights — loud instead of silently
    truncated (``strict=False`` restores truncation-to-nearest).

    Returns ``(idx [g, max_obs] int32, weights [g, max_obs])``.
    """
    obs_x = obs_coords[:, coord_col]
    grid_x = grid_coords[:, coord_col]
    n_obs = obs_x.shape[0]
    nb = min(max_obs, n_obs)
    # Exactness guard (traced-safe): unsorted obs coordinates would silently
    # return wrong neighborhoods; poison the weights with NaN instead so the
    # failure is loud. O(o) — negligible against the taper evaluation.
    sorted_ok = (
        jnp.all(obs_x[1:] >= obs_x[:-1]) if n_obs > 1 else jnp.asarray(True)
    )
    # 'sort' = one merge-rank sort of [o + g] values instead of a
    # binary-search scan per column
    center = jnp.searchsorted(obs_x, grid_x, method="sort")
    start = jnp.clip(center - nb // 2, 0, n_obs - nb)
    overflow = jnp.zeros_like(grid_x)
    radius = np.atleast_1d(
        np.asarray(getattr(localization, "radius", np.nan), dtype=float)
    )
    if (
        isinstance(localization, (GaspariCohn, GaspariCohnInf))
        and radius.size == 1
        and nb < n_obs
    ):
        # Single-radius Gaspari-Cohn along a plain |x - y| coordinate: the
        # in-support obs form a contiguous index range [l, h). Clamp the
        # rank-centered window onto it (exact for asymmetric distributions
        # too), and NaN-poison columns whose in-support count exceeds the
        # window — "at most max_obs nonzero-taper obs per column" becomes
        # the exact-iff condition, enforced loudly (same contract as the
        # monolithic window kernels, ops/window.py).
        taper_name = (
            "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"
        )
        sup = taper_support_z(taper_name, localization.epsilon) * radius[0]
        sup = jnp.asarray(sup, obs_x.dtype)
        low = jnp.searchsorted(obs_x, grid_x - sup, side="right",
                               method="sort")
        high = jnp.searchsorted(obs_x, grid_x + sup, method="sort")
        start = jnp.clip(center - nb // 2, high - nb, low)
        start = jnp.clip(start, 0, n_obs - nb)
        if strict:
            overflow = jnp.where(high - low > nb, jnp.nan, 0.0).astype(
                grid_x.dtype
            )
    idx = start[:, None] + jnp.arange(nb, dtype=center.dtype)[None, :]
    sel_info = obs_coords[idx]                             # [g, nb, d]
    dist = jax.vmap(
        lambda gc, oi: jnp.atleast_2d(localization.dist_func(gc, oi))
    )(grid_coords, sel_info)                               # [g, n_dim, nb]
    weights = localization.taper_from_dist(dist)           # [g, nb]
    weights = weights + jnp.where(sorted_ok, 0.0, jnp.nan).astype(
        weights.dtype
    )
    weights = weights + overflow[:, None].astype(weights.dtype)
    if nb < max_obs:
        pad = max_obs - nb
        weights = jnp.pad(weights, ((0, 0), (0, pad)))
        idx = jnp.pad(idx, ((0, 0), (0, pad)))
    return idx.astype(jnp.int32), weights
