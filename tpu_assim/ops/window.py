"""
Windowed localized-ETKF analysis over sorted observation windows, in plain
XLA.

Each grid column solves over a fixed-size window of ``nb`` observations (the
LETKF obs-count bound). With ``Zh`` the sqrt(taper)-scaled neighbourhood
perturbations [nb, K] of one column, ``X = I + Zh Zh^T / reg`` (nb x nb),
the dual (Woodbury) form of the analysis is

    analysis = mean
             + (Zh^T X^{-1} yh) / reg                            (mean update)
             + alpha * sp                                        (inflated perts)
             - (alpha / reg) * Zh^T f(X) (Zh sp),  f(x) = 1/(sqrt(x)(1+sqrt(x)))

with ``alpha = sqrt((K-1)/reg)`` and ``sp`` the state perturbations of the
column. The K x K weight matrices are never formed, and the two matrix
functions are applied to vectors by one joint Chebyshev/Clenshaw
recurrence (:func:`_cheb_solve_apply`).

Reference semantics: pytassim/core/etkf.py:57-77 (weight solve),
pytassim/interface/wrapper.py:86-99 (localized scaling),
pytassim/interface/base.py:256-278 (weight application).
"""

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "letkf_nbh_analysis_cheb",
    "letkf_window_analysis_fused",
    "letkf_window_analysis_fused_2d",
    "cheb_degree_for",
    "required_obs_block_2d",
    "max_in_support_1d",
    "max_in_support_2d",
]


def cheb_degree_for(lam_max: float, tol: float = 1e-6,
                    lo: int = 6, hi: int = 96) -> int:
    """Chebyshev degree reaching truncation error ``tol`` for the solve
    functions ``1/x`` and ``1/(sqrt(x)(1+sqrt(x)))`` on ``[1, lam_max]``.

    Both functions are analytic on the interval with the nearest singularity
    at ``x = 0``, so their Chebyshev coefficients decay like ``rho^-m`` with
    ``rho = (sqrt(lam) + 1)/(sqrt(lam) - 1)`` (the Bernstein-ellipse
    parameter through 0). The degree is the smallest ``d`` with
    ``rho^-d <= tol`` — a slightly conservative bound (the measured
    end-to-end error is ~10-30x below it, tests/test_letkf_fused_interface).
    """
    import math

    lam = max(float(lam_max), 1.0 + 1e-6)
    rho = (math.sqrt(lam) + 1.0) / (math.sqrt(lam) - 1.0)
    d = int(math.ceil(math.log(1.0 / tol) / math.log(rho)))
    return max(lo, min(hi, d))


def required_obs_block_2d(obs_y, grid_y, radius_y: float,
                          tile: int = 128) -> int:
    """Exact per-tile obs block width for
    :func:`letkf_window_analysis_fused_2d` (host-side, numpy).

    A tile's block holds every observation inside its y-band
    ``[min(gy) - 2 ry, max(gy) + 2 ry]`` (the Gaspari-Cohn support along y);
    this returns the maximum band population over tiles, rounded up to a
    multiple of 8 —
    the smallest block that never drops an in-support observation.
    ``obs_y`` need not be sorted (the analysis sorts internally).
    """
    import numpy as np

    obs_y = np.sort(np.asarray(obs_y))
    grid_y = np.asarray(grid_y)
    o = obs_y.shape[0]
    g = grid_y.shape[0]
    n_tiles = -(-g // tile)
    pad = n_tiles * tile - g
    if pad:
        grid_y = np.concatenate([grid_y, np.full(pad, grid_y[-1])])
    tiles = grid_y.reshape(n_tiles, tile)
    lo = tiles.min(axis=1) - 2.0 * radius_y
    hi = tiles.max(axis=1) + 2.0 * radius_y
    counts = (np.searchsorted(obs_y, hi, side="right")
              - np.searchsorted(obs_y, lo))
    width = max(int(counts.max()) if n_tiles else 8, 8)
    return min(o, -(-width // 8) * 8)


def max_in_support_1d(obs_x, grid_x, radius: float, taper: str = "gc2",
                      epsilon: float = 1e-5) -> int:
    """Max per-column count of in-support observations (host-side numpy,
    exact): obs with taper weight > epsilon, i.e. ``|x - gx| < z* radius``
    with ``z* = taper_support_z(taper, epsilon)``. The window analyses are
    exact iff this is <= ``nb`` — concrete callers raise on violation
    instead of relying on the analyses' NaN-poisoning."""
    import numpy as np

    from tpu_assim.ops.localization import taper_support_z

    obs_x = np.sort(np.asarray(obs_x))
    grid_x = np.asarray(grid_x)
    s = taper_support_z(taper, epsilon) * radius
    lo = np.searchsorted(obs_x, grid_x - s, side="right")
    hi = np.searchsorted(obs_x, grid_x + s, side="left")
    return int((hi - lo).max()) if grid_x.size else 0


def max_in_support_2d(obs_xy, grid_xy, radius_x: float, radius_y: float,
                      taper: str = "gc2", epsilon: float = 1e-5,
                      tile: int = 128) -> int:
    """Max per-column count of y-band observations inside the x-cutoff
    (host-side numpy, exact) — the 2-D window analysis's slot-exhaustion
    measure: per grid tile the band is ``[min(gy) - 2 ry, max(gy) + 2 ry]``
    (mirroring the analysis prologue), and each column counts band obs with
    ``|dx| < z* rx``. The 2-D window analysis is exact iff this is <= ``nb``.
    """
    import numpy as np

    from tpu_assim.ops.localization import taper_support_z

    obs_xy = np.asarray(obs_xy)
    grid_xy = np.asarray(grid_xy)
    g = grid_xy.shape[0]
    if g == 0 or obs_xy.shape[0] == 0:
        return 0
    order = np.argsort(obs_xy[:, 1], kind="stable")
    oy = obs_xy[order, 1]
    ox = obs_xy[order, 0]
    sx = taper_support_z(taper, epsilon) * radius_x
    n_tiles = -(-g // tile)
    worst = 0
    for t in range(n_tiles):
        gx = grid_xy[t * tile:(t + 1) * tile, 0]
        gy = grid_xy[t * tile:(t + 1) * tile, 1]
        b0 = np.searchsorted(oy, gy.min() - 2.0 * radius_y)
        b1 = np.searchsorted(oy, gy.max() + 2.0 * radius_y, side="right")
        if b1 <= b0:
            continue
        bx = np.sort(ox[b0:b1])
        lo = np.searchsorted(bx, gx - sx, side="right")
        hi = np.searchsorted(bx, gx + sx, side="left")
        worst = max(worst, int((hi - lo).max()))
    return worst


# ---------------------------------------------------------------------------
# Chebyshev/Clenshaw solve + weight application
# ---------------------------------------------------------------------------
#
# The analysis only needs the action of two matrix functions on vectors per
# column:
#
#     q = X^{-1} yh                      (mean update <u, q>/reg)
#     v = f(X) u,  f(x) = 1/(sqrt(x) (1 + sqrt(x)))   (perturbation update)
#
# with X = I + Zh Zh^T / reg whose spectrum lies in [1, 1 + min(||S||_inf,
# tr S)/reg]. Both are evaluated with one degree-d Chebyshev expansion each
# (coefficients computed per column from f at the mapped Chebyshev nodes via
# a static DCT matmul) and a joint Clenshaw recurrence of batched matvecs.
#
# Layout: grid columns are the LAST axis ([.., G]), so every per-column
# matvec S @ v is an elementwise multiply plus a reduction over a leading
# axis, which XLA fuses into one loop — no [G, nb, nb] batched matmuls.


def _cheb_nodes_dct(degree: int):
    import numpy as np

    j = np.arange(degree + 1)
    nodes = np.cos(np.pi * (j + 0.5) / (degree + 1))        # [-1, 1]
    m = np.arange(degree + 1)[:, None]
    dct = np.cos(np.pi * m * (j[None, :] + 0.5) / (degree + 1))
    dct = dct * (2.0 / (degree + 1))
    dct[0] *= 0.5
    return nodes.astype(np.float32), dct.astype(np.float32)


def _cheb_solve_apply(nodes, dct_mat, zh, yh, sp, mean, reg,
                      ens_size, degree):
    """Shared Chebyshev/Clenshaw solve + weight application, columns last.

    zh [nb, k, G] scaled neighborhood perts; yh [nb, G] scaled innovations;
    sp [ns, k, G] state perturbations of ns stacked (var, time) slices;
    mean [ns, 1, G] -> analysis [ns, k, G].

    The obs-space solve (Gram S, spectral bound, coefficients, q = X^{-1} yh)
    is shared across the ns state slices; only the per-slice operands
    u_i = Zh sp_i ride along. All 1 + ns Clenshaw operands run in ONE joint
    recurrence.
    """
    f32 = jnp.float32
    nb = zh.shape[0]
    ns = sp.shape[0]
    # per-row broadcast-multiply + reduce over k: one fused loop each
    s = jnp.stack(
        [jnp.sum(zh[n][None, :, :] * zh, axis=1) for n in range(nb)],
        axis=0,
    )  # [nb, nb, G]

    # spectral upper bound per column (exact bound; 1.05 floor keeps the
    # affine map well-conditioned — columns with lam_max below the floor
    # only get a slightly wider, still-valid interval)
    eye_nb = jnp.eye(nb, dtype=f32)[:, :, None]
    inf_norm = jnp.max(jnp.sum(jnp.abs(s), axis=1), axis=0)
    trace = jnp.sum(s * eye_nb, axis=(0, 1))
    lam_ub = 1.0 + jnp.minimum(inf_norm, trace) / reg
    lam_ub = jnp.maximum(lam_ub, 1.05)                       # [G]

    # Chebyshev coefficients of f1(x)=1/x and f2(x)=1/(sqrt(x)(1+sqrt(x)))
    # on [1, lam_ub], per column: evaluate at mapped nodes, static DCT.
    t_nodes = nodes.reshape(-1, 1)                           # [d+1, 1]
    half_w = 0.5 * (lam_ub - 1.0)[None, :]
    x_nodes = (1.0 + half_w) + half_w * t_nodes              # [d+1, G]
    f1x = 1.0 / x_nodes
    sq = jnp.sqrt(x_nodes)
    f2x = 1.0 / (sq * (1.0 + sq))
    hp = jax.lax.Precision.HIGHEST
    c1 = jnp.einsum("mj,jc->mc", dct_mat, f1x,
                    preferred_element_type=f32, precision=hp)
    c2 = jnp.einsum("mj,jc->mc", dct_mat, f2x,
                    preferred_element_type=f32, precision=hp)
    # per-operand coefficient stack: slot 0 = f1 (innovations), 1.. = f2
    c_all = jnp.concatenate(
        [c1[:, None, :],
         jnp.broadcast_to(c2[:, None, :], c2.shape[:1] + (ns,) + c2.shape[1:])],
        axis=1,
    )                                                        # [d+1, 1+ns, G]

    # normalized operator: Xt = (2 X - (lam_ub + 1) I) / (lam_ub - 1) with
    # X = I + S/reg. The identity a_sc + b_sc == -1 (a_sc = 2/(lam_ub - 1),
    # b_sc = -(lam_ub + 1)/(lam_ub - 1)) collapses the affine map to
    # Xt v = (a_sc/reg) S v - v.
    a2_sc = (2.0 / (lam_ub - 1.0) / reg)[None, :]            # [1, G]

    def xt(vec):  # [1+ns, nb, G] -> [1+ns, nb, G]
        sv = jnp.sum(s[None] * vec[:, None, :, :], axis=2)  # S @ vec
        return a2_sc * sv - vec

    u = jnp.stack(
        [jnp.sum(zh * sp[i][None, :, :], axis=1) for i in range(ns)],
        axis=0,
    )                                                        # [ns, nb, G]
    w_all = jnp.concatenate([yh[None], u], axis=0)           # [1+ns, nb, G]

    b1 = jnp.zeros_like(w_all)
    b2 = jnp.zeros_like(w_all)
    for m_i in range(degree, 0, -1):
        b0 = c_all[m_i][:, None, :] * w_all + 2.0 * xt(b1) - b2
        b2, b1 = b1, b0
    res = c_all[0][:, None, :] * w_all + xt(b1) - b2         # [1+ns, nb, G]
    q = res[0]                                               # X^{-1} yh
    v = res[1:]                                              # f2(X) u

    alpha = jnp.sqrt((ens_size - 1.0) / reg)
    mean_upd = jnp.sum(u * q[None], axis=1, keepdims=True) / reg  # [ns, 1, G]
    zv = jnp.stack(
        [jnp.sum(zh * v[i][:, None, :], axis=0) for i in range(ns)],
        axis=0,
    )                                                        # [ns, k, G]
    return mean + mean_upd + alpha * sp - (alpha / reg) * zv


@functools.partial(jax.jit, static_argnames=("ens_size", "degree"))
def letkf_nbh_analysis_cheb(
    zh: jnp.ndarray,
    yh: jnp.ndarray,
    sp: jnp.ndarray,
    mean: jnp.ndarray,
    reg: jnp.ndarray,
    ens_size: int,
    degree: int = 16,
) -> jnp.ndarray:
    """Localized-ETKF analysis over gathered neighbourhoods, Chebyshev/
    Clenshaw form.

    Parameters
    ----------
    zh : [nb, k, g] sqrt(taper-weight)-scaled neighborhood obs perturbations.
    yh : [nb, g] scaled innovations.
    sp : [k, g] — or [ns, k, g] for ns stacked (var, time) state slices that
        share the same obs-space solve (the 4-D interface state reshaped to
        [v*t, k, g]; the reference applies ONE weight matrix per column to
        every (var, time) slice, base.py:256-278).
    mean : [g] (or [ns, g]) state ensemble mean.
    reg : scalar regularizer ``(K-1)/rho``.
    ens_size : ensemble size K (static).
    degree : Chebyshev degree (static; 12 reaches ~1e-6 for the benchmark
        conditioning, see tests).

    Returns
    -------
    analysis : [k, g] (or [ns, k, g]) analysed ensemble (member-major).
    """
    multi = sp.ndim == 3
    if not multi:
        sp = sp[None]
        mean = mean[None]
    f32 = jnp.float32
    nodes, dct = _cheb_nodes_dct(degree)
    out = _cheb_solve_apply(
        jnp.asarray(nodes), jnp.asarray(dct), zh.astype(f32),
        yh.astype(f32), sp.astype(f32), mean.astype(f32)[:, None, :],
        reg.astype(f32), ens_size, degree,
    )
    return out if multi else out[0]


# ---------------------------------------------------------------------------
# 1-D window analysis: selection + taper + gather + solve + apply
# ---------------------------------------------------------------------------
#
# For sorted 1-D obs coordinates each column's in-support observations are
# one contiguous index range, so selection is a searchsorted and a window of
# nb consecutive indices — O(g * nb) instead of a dense [g, o] taper and a
# top-k:
#
#   1. window start per column: rank-centred, then clamped onto the column's
#      in-support index range [l, h) (obs within the taper support),
#   2. gather of obs_x, the normalized innovation and the perturbations for
#      the nb window slots,
#   3. Gaspari-Cohn taper on |obs_x - grid_x| (polynomials inline,
#      pytassim/localization/gaspari_cohn.py:77-95), sqrt-weight scaling,
#   4. the Chebyshev/Clenshaw solve + weight application above.


def _taper_poly(z, taper: str, epsilon: float):
    """Gaspari-Cohn taper on normalized distances ``z = |dx| / radius``,
    branch-free, sub-epsilon cut to exact zero. The piecewise polynomials are
    the class statics of :mod:`tpu_assim.ops.localization` (single source of
    truth; reference: pytassim/localization/gaspari_cohn.py:77-95 for
    GC(z,1/2,c), :175-214 for GC(z,inf,c))."""
    from tpu_assim.ops.localization import GaspariCohn, GaspariCohnInf

    if taper == "gc2":
        z_safe = jnp.maximum(z, 0.5)  # keeps the 1/z term finite off-branch
        w = jnp.where(z < 2.0, GaspariCohn._f2(z_safe), 0.0)
        w = jnp.where(z < 1.0, GaspariCohn._f1(z), w)
    elif taper == "gcinf":
        z_safe = jnp.maximum(z, 0.25)
        w = jnp.where(z < 2.0, GaspariCohnInf._f4(z_safe), 0.0)
        w = jnp.where(z < 1.5, GaspariCohnInf._f3(z_safe), w)
        w = jnp.where(z < 1.0, GaspariCohnInf._f2(z_safe), w)
        w = jnp.where(z < 0.5, GaspariCohnInf._f1(z), w)
    else:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    return jnp.where(w > epsilon, w, 0.0)


def _window_starts(obs_x, grid_x, radius, *, nb, epsilon, taper, strict):
    """Window placement for sorted ``obs_x``: per column the first of its
    ``nb`` window slots, and an additive NaN poison [G] for columns whose
    selection would truncate.

    The start is rank-centred, then clamped onto the column's in-support
    index range [l, h) (obs with taper weight > epsilon; contiguous in the
    sorted coordinates). The clamp keeps the window exact for ASYMMETRIC
    in-support distributions too — a purely rank-centred start truncates
    e.g. 12-left/2-right at nb=16 even though the total fits — and makes
    "no column has more than nb in-support obs" the exact-iff condition.
    ``strict`` poisons the columns that violate it (loud, never silently
    wrong; concrete callers raise first on the host, analysis.py).
    """
    from tpu_assim.ops.localization import taper_support_z

    o = obs_x.shape[0]
    rank = jnp.searchsorted(obs_x, grid_x, side="right", method="sort")
    sup = jnp.asarray(taper_support_z(taper, epsilon), obs_x.dtype) * radius
    low = jnp.searchsorted(obs_x, grid_x - sup, side="right", method="sort")
    high = jnp.searchsorted(obs_x, grid_x + sup, method="sort")
    start = jnp.clip(rank - nb // 2, high - nb, low)
    start = jnp.clip(start, 0, max(o - nb, 0)).astype(jnp.int32)
    poison = jnp.zeros(grid_x.shape, jnp.float32)
    if strict and o > nb:
        poison = jnp.where(high - low > nb, jnp.nan, 0.0).astype(jnp.float32)
    return start, poison


def _window_plain(perts, innov, obs_x, grid_x, start, poison, sp, mean,
                  reg, radius, *, ens_size, nb, degree, epsilon, taper):
    """Plain-XLA 1-D window analysis over the prologue's window starts —
    the CPU path and the reverse-mode rule of the GPU kernel
    (:mod:`tpu_assim.ops.window_kernel`), with the same signature. Slots
    past the last observation (only when o < nb) get weight 0."""
    from tpu_assim.ops.localization import safe_sqrt

    o = obs_x.shape[0]
    idx = start[:, None] + jnp.arange(nb, dtype=start.dtype)[None, :]
    valid = idx < o
    idx = jnp.minimum(idx, o - 1)
    z = jnp.abs(obs_x[idx] - grid_x[:, None]) / radius     # [G, nb]
    sw = safe_sqrt(jnp.where(valid, _taper_poly(z, taper, epsilon), 0.0)).T
    zh = perts[:, idx].transpose(2, 0, 1) * sw[:, None, :]  # [nb, k, G]
    yh = innov[idx].T * sw                                  # [nb, G]
    nodes, dct = _cheb_nodes_dct(degree)
    return _cheb_solve_apply(
        jnp.asarray(nodes), jnp.asarray(dct), zh, yh + poison[None, :], sp,
        mean[:, None, :], reg, ens_size, degree,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(10, 11))
def _window_call(perts, innov, obs_x, grid_x, start, poison, sp, mean, reg,
                 radius, statics, interpret):
    """GPU kernel forward (plain twin on the CPU, see
    :func:`tpu_assim.device.kernel_or_plain`); the reverse pass is
    reverse-mode AD of the plain twin — the exact gradient of the
    degree-d Chebyshev analysis the forward computes."""
    from tpu_assim.device import kernel_or_plain
    from tpu_assim.ops.window_kernel import window_analysis_kernel

    opts = dict(zip(("ens_size", "nb", "degree", "epsilon", "taper"),
                    statics))
    args = (perts, innov, obs_x, grid_x, start, poison, sp, mean, reg,
            radius)
    return kernel_or_plain(
        functools.partial(window_analysis_kernel, **opts),
        functools.partial(_window_plain, **opts), *args,
        interpret=interpret,
    )


def _window_call_fwd(*args):
    return _window_call(*args), args[:10]


def _window_call_bwd(statics, interpret, res, g):
    opts = dict(zip(("ens_size", "nb", "degree", "epsilon", "taper"),
                    statics))
    _, vjp = jax.vjp(functools.partial(_window_plain, **opts), *res)
    return vjp(g)


_window_call.defvjp(_window_call_fwd, _window_call_bwd)


@functools.partial(
    jax.jit,
    static_argnames=("ens_size", "nb", "degree", "epsilon", "taper",
                     "strict", "interpret"),
)
def letkf_window_analysis_fused(
    perts: jnp.ndarray,
    innov: jnp.ndarray,
    obs_x: jnp.ndarray,
    grid_x: jnp.ndarray,
    sp: jnp.ndarray,
    mean: jnp.ndarray,
    reg: jnp.ndarray,
    radius: float,
    ens_size: int,
    nb: int = 16,
    degree: int = 16,
    epsilon: float = 1e-5,
    taper: str = "gc2",
    strict: bool = True,
    interpret: bool = False,
) -> jnp.ndarray:
    """The complete 1-D-window LETKF analysis: XLA prologue (window starts
    by ``searchsorted``, exactness guards), then one fused GPU kernel
    (:mod:`tpu_assim.ops.window_kernel`) — or its plain XLA twin on the
    CPU.

    Parameters
    ----------
    perts : [k, o] R^{-1/2}-normalized obs-space perturbations.
    innov : [o] normalized innovations.
    obs_x : [o] obs coordinates, SORTED ascending.
    grid_x : [g] grid coordinates (any order).
    sp : [k, g] state perturbations — or [ns, k, g] for ns stacked
        (var, time) state slices sharing the obs-space solve; mean [g]
        (or [ns, g]) state mean.
    reg : scalar (K-1)/rho; radius : Gaspari-Cohn radius.
    nb : window size. The window is rank-centered, then clamped onto the
        column's in-support index range — exact IFF every column has at
        most nb nonzero-taper obs (and obs are sorted); ``strict=True``
        (default) NaN-poisons any column violating that, so the analysis is
        never silently approximate. ``strict=False`` accepts the
        truncation-to-nearest (the standard LETKF obs-count bound).
        Unsorted ``obs_x`` NaN-poisons the whole output.
    taper : ``"gc2"`` (Gaspari-Cohn GC(z,1/2,c), the default) or
        ``"gcinf"`` (GC(z,inf,c)) — see :func:`_taper_poly`.
    interpret : run the GPU kernel through the Pallas interpreter (tests).

    Returns analysis [k, g] (or [ns, k, g]). Differentiable in every array
    input, the coordinates included (through the taper; the integer window
    selection is piecewise constant).
    """
    o = perts.shape[1]
    multi = sp.ndim == 3
    if not multi:
        sp = sp[None]
        mean = mean[None]
    f32 = jnp.float32
    obs_x = obs_x.astype(f32)
    grid_x = grid_x.astype(f32)
    radius = jnp.asarray(radius, f32)
    mean = mean.astype(f32)
    # Exactness guard (traced-safe): unsorted obs coordinates would silently
    # select wrong windows — poison the whole output with NaN instead.
    if o > 1:
        sorted_ok = jnp.all(obs_x[1:] >= obs_x[:-1])
        mean = mean + jnp.where(sorted_ok, 0.0, jnp.nan).astype(f32)
    start, poison = _window_starts(obs_x, grid_x, radius, nb=nb,
                                   epsilon=epsilon, taper=taper,
                                   strict=strict)
    out = _window_call(
        perts.astype(f32), innov.astype(f32), obs_x, grid_x, start, poison,
        sp.astype(f32), mean, jnp.asarray(reg, f32), radius,
        (ens_size, nb, degree, epsilon, taper), interpret,
    )
    return out if multi else out[0]


# ---------------------------------------------------------------------------
# 2-D window analysis
# ---------------------------------------------------------------------------
#
# 2-D domains use a two-level selection:
#
#   prologue: obs are sorted by y; each grid tile's candidate block is the
#     contiguous y-sorted slice inside the tile's y-band
#     [min(gy) - 2 ry, max(gy) + 2 ry] (the Gaspari-Cohn support along y);
#   per tile: the 1-D window selection runs on the block's x coordinates
#     (block sorted by x, ties by index), and the taper is the
#     per-dimension product GC(|dx|/rx) * GC(|dy|/ry) (reference behavior:
#     pytassim/localization/gaspari_cohn.py:124-134), followed by the same
#     Chebyshev solve + apply.
#
# Exact when (a) the block holds the tile's whole y-band
# (required_obs_block_2d) and (b) no column has more than ``nb`` band obs
# inside its x-cutoff — the 2-D analog of the 1-D window condition. The
# grid ordering only affects efficiency (a row-major grid gives thin
# y-bands), never correctness: bands come from each tile's actual min/max.


@functools.partial(
    jax.jit,
    static_argnames=("radius_x", "radius_y", "ens_size", "nb", "degree",
                     "tile", "epsilon", "obs_block", "taper", "strict",
                     "extra_radii"),
)
def letkf_window_analysis_fused_2d(
    perts: jnp.ndarray,
    innov: jnp.ndarray,
    obs_xy: jnp.ndarray,
    grid_xy: jnp.ndarray,
    sp: jnp.ndarray,
    mean: jnp.ndarray,
    reg: jnp.ndarray,
    radius_x: float,
    radius_y: float,
    ens_size: int,
    obs_block: int,
    nb: int = 48,
    degree: int = 16,
    tile: int = 128,
    epsilon: float = 1e-5,
    taper: str = "gc2",
    strict: bool = True,
    extra_radii: tuple = (),
) -> jnp.ndarray:
    """The complete 2-D-window LETKF analysis as one jitted program.

    Parameters
    ----------
    perts : [k, o] R^{-1/2}-normalized obs-space perturbations.
    innov : [o] normalized innovations.
    obs_xy : [o, d] obs (x, y, ...) coordinates — any order (sorted
        internally); d = 2 + len(extra_radii).
    grid_xy : [g, d] grid coordinates; order affects only efficiency (a
        row-major grid gives thin per-tile y-bands), never correctness.
    sp / mean : state perturbations / mean, [k, g] or [ns, k, g].
    reg : scalar (K-1)/rho; radius_x / radius_y : static per-dimension
        Gaspari-Cohn radii (the taper is the per-dimension product).
    obs_block : per-tile y-band block width — REQUIRED; pass
        :func:`required_obs_block_2d` (exact for concrete coordinates).
        Overflowing tiles are NaN-poisoned, never silently truncated.
    nb : x-window size inside the y-band block; exact IFF no column has
        more than ``nb`` band obs within its x-cutoff. ``strict=True``
        (default) NaN-poisons any violating column; ``strict=False``
        accepts the truncation-to-x-nearest.
    tile : grid columns that share one y-band block.
    extra_radii : static radii for coordinate dims >= 3 (e.g. the COSMO
        vertical): those dims contribute product taper factors only — the
        two-level band/window selection stays on (y, x), so the exactness
        condition above is unchanged (and conservative: extra dims can
        only zero weights, never add in-support obs).

    Returns analysis [k, g] (or [ns, k, g]). Differentiable in every array
    input (the band and window indices are piecewise constant).
    """
    k, o = perts.shape
    g = grid_xy.shape[0]
    n_dims = 2 + len(extra_radii)
    if obs_xy.shape[1] < n_dims or grid_xy.shape[1] < n_dims:
        raise ValueError(
            f"need {n_dims} coordinate columns for 2 windowed + "
            f"{len(extra_radii)} extra taper dims; got obs {obs_xy.shape}, "
            f"grid {grid_xy.shape}"
        )
    if obs_block <= 0:
        raise ValueError(
            "obs_block is required for the 2-D window analysis; compute it "
            "with required_obs_block_2d(obs_y, grid_y, radius_y, tile)"
        )
    multi = sp.ndim == 3
    if not multi:
        sp = sp[None]
        mean = mean[None]
    f32 = jnp.float32
    n_tiles = -(-g // tile)
    pad = n_tiles * tile - g
    if pad:
        grid_xy = jnp.pad(grid_xy, ((0, pad), (0, 0)), mode="edge")
        sp = jnp.pad(sp, ((0, 0), (0, 0), (0, pad)))
        mean = jnp.pad(mean, ((0, 0), (0, pad)))
    mean3 = mean.astype(f32)[:, None, :]

    # sort obs by y (internal — no precondition on the input order)
    oy_order = jnp.argsort(obs_xy[:, 1])
    table = jnp.concatenate(
        [perts[:, oy_order], innov[oy_order][None, :],
         obs_xy[oy_order, :n_dims].T], axis=0,
    ).astype(f32)                                          # [k+1+d, o]
    grid2 = grid_xy[:, :n_dims].T.astype(f32)              # [d, G]
    scal = jnp.stack(
        [jnp.asarray(reg, f32), jnp.asarray(radius_x, f32),
         jnp.asarray(radius_y, f32)]
        + [jnp.asarray(r, f32) for r in extra_radii]
    )
    opts = dict(ens_size=ens_size, nb=nb, degree=degree, epsilon=epsilon,
                taper=taper, strict=strict, tile=tile, n_dims=n_dims)

    o_b = min(obs_block, o)
    if o_b >= o:
        # every tile takes the whole table
        bands = jnp.broadcast_to(jnp.asarray([0, 0, o], jnp.int32),
                                 (n_tiles, 3))
    else:
        ty = grid2[1].reshape(n_tiles, tile)
        lo = ty.min(axis=1) - 2.0 * radius_y
        hi = ty.max(axis=1) + 2.0 * radius_y
        oy_all = table[k + 2]
        iy0 = jnp.searchsorted(oy_all, lo, method="sort").astype(jnp.int32)
        iy1 = jnp.searchsorted(oy_all, hi, side="right",
                               method="sort").astype(jnp.int32)
        # Exactness guard: band population beyond the block width would
        # silently drop in-support observations — NaN-poison those tiles.
        bad_tile = (iy1 - iy0) > o_b
        mean3 = mean3 + jnp.where(
            jnp.repeat(bad_tile, tile), jnp.nan, 0.0
        ).astype(f32)[None, None, :]
        off = jnp.clip(iy0, 0, o - o_b)
        bands = jnp.stack([off, iy0 - off, jnp.minimum(iy1 - off, o_b)],
                          axis=1)                          # [n_tiles, 3]
    out = _window2d_tiles(table, bands, o_b, grid2, sp.astype(f32), mean3,
                          scal, **opts)[:, :, :g]
    return out if multi else out[0]


def _window2d_tiles(table, bands, o_b, grid2, sp, mean3, scal, *, ens_size,
                    nb, degree, epsilon, taper, strict, tile, n_dims=2):
    """Per-tile 2-D window analysis over a y-sorted obs table.

    table [k+1+d, o] (perts, innovation, coordinates); bands [n_tiles, 3]
    int (block offset, band start, band end relative to the offset) of
    the ``o_b``-wide block of each tile; grid2 [d, G]; sp
    [ns, k, G]; mean3 [ns, 1, G]; G a multiple of ``tile``. Band slots
    outside [start, end) get x = +float32.max: they enter no count and
    have zero taper weight.

    Tiles run in chunks (``lax.map`` with a batch size) so that the
    [nb, nb, columns] Gram of one chunk stays near 0.5 GB at any grid size.
    """
    from tpu_assim.ops.localization import safe_sqrt

    f32 = jnp.float32
    reg = scal[0]
    rx = scal[1]
    ry = scal[2]
    ns, k, gp = sp.shape
    n_tiles = gp // tile
    x_row = ens_size + 1
    big = jnp.asarray(jnp.finfo(f32).max, f32)
    nodes, dct = _cheb_nodes_dct(degree)

    def one_tile(args):
        band, gt, spt_, mt_ = args
        pk = jax.lax.dynamic_slice_in_dim(table, band[0], o_b, axis=1)
        slot = jnp.arange(o_b)
        in_band = (slot >= band[1]) & (slot < band[2])
        pk = pk.at[x_row].set(jnp.where(in_band, pk[x_row], big))
        # positional selection needs the block x-sorted (stable: ties by
        # index); blocks arrive in y-order
        pk = pk[:, jnp.argsort(pk[x_row], stable=True)]
        obs_x = pk[x_row]                                  # [o_b]
        gxt = gt[0]
        start, poison = _window_starts(obs_x, gxt, rx, nb=nb,
                                       epsilon=epsilon, taper=taper,
                                       strict=strict)
        idx = start[:, None] + jnp.arange(nb, dtype=jnp.int32)[None, :]
        valid = idx < o_b
        sel = pk[:, jnp.minimum(idx, o_b - 1)]             # [rows, T, nb]
        w = jnp.where(valid, 1.0, 0.0)
        for j in range(n_dims):
            r = (rx, ry)[j] if j < 2 else scal[1 + j]
            zj = jnp.abs(sel[x_row + j] - gt[j][:, None]) / r
            w = w * _taper_poly(zj, taper, 0.0)
        w = jnp.where(w > epsilon, w, 0.0)
        sw = safe_sqrt(w).T                                # [nb, T]
        zh = sel[:ens_size].transpose(2, 0, 1) * sw[:, None, :]  # [nb, k, T]
        yh = sel[ens_size].T * sw + poison[None, :]        # [nb, T]
        return _cheb_solve_apply(
            jnp.asarray(nodes), jnp.asarray(dct), zh, yh, spt_, mt_, reg,
            ens_size, degree,
        )

    gt = grid2.reshape(n_dims, n_tiles, tile).transpose(1, 0, 2)
    spt = sp.reshape(ns, k, n_tiles, tile).transpose(2, 0, 1, 3)
    mt = mean3.reshape(ns, 1, n_tiles, tile).transpose(2, 0, 1, 3)
    batch = max(1, min(n_tiles, (1 << 27) // (nb * nb * tile)))
    out_t = jax.lax.map(one_tile, (bands.astype(jnp.int32), gt, spt, mt),
                        batch_size=batch)
    return out_t.transpose(1, 2, 0, 3).reshape(ns, k, gp)
