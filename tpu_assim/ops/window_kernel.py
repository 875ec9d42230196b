"""
The 1-D window analysis as one Pallas kernel for NVIDIA GPUs (Triton route).

The plain XLA path (:func:`tpu_assim.ops.window._window_plain`) writes the
scaled window operands ``zh [nb, k, G]`` to device memory and reads them
back for the Gram, the projections and the weight application, and reads the
``[nb, nb, G]`` Gram at every Clenshaw step. This kernel keeps each column's
Gram and recurrence on chip: one block owns ``BLOCK_G`` columns (the fast
axis of every tile), gathers each window slot's observation row straight
from the obs table (which stays in L2), builds the Gram and the projections
in one pass over the ensemble, runs the joint Clenshaw recurrence on
``[nb_pad, BLOCK_G]`` slabs, and writes only the analysed
``[ns, k, BLOCK_G]`` tile. The window starts and the exactness poison come
from XLA's ``searchsorted`` prologue (:func:`tpu_assim.ops.window.
_window_starts`).

Compiled only for the GPU; ``interpret=True`` runs it through the Pallas
interpreter (the CPU tests). The plain twin is its reverse-mode rule.
"""

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["window_analysis_kernel", "block_shape"]


def block_shape(nb: int) -> tuple:
    """``(nb_pad, block_g)``: the window padded to a power of two, and the
    columns per block, sized so the ``[nb_pad, nb_pad, block_g]`` Gram
    holds 8192 floats (64 registers per thread at 4 warps)."""
    nb_pad = max(2, 1 << (nb - 1).bit_length())
    block_g = max(16, min(256, 8192 // (nb_pad * nb_pad)))
    return nb_pad, block_g


def _cheb_coefficients(degree: int):
    """Python floats: Chebyshev nodes on [-1, 1] and the DCT matrix that
    maps function values at the nodes to expansion coefficients (the same
    numbers as :func:`tpu_assim.ops.window._cheb_nodes_dct`)."""
    n = degree + 1
    nodes = [math.cos(math.pi * (j + 0.5) / n) for j in range(n)]
    dct = [[math.cos(math.pi * m * (j + 0.5) / n) * 2.0 / n
            * (0.5 if m == 0 else 1.0) for j in range(n)] for m in range(n)]
    return nodes, dct


def _kernel(scal_ref, gx_ref, start_ref, poison_ref, perts_ref, innov_ref,
            obsx_ref, sp_ref, mean_ref, out_ref, *, ens_size, ns, nb, nb_pad,
            block_g, n_obs, degree, epsilon, taper):
    from tpu_assim.ops.window import _taper_poly

    f32 = jnp.float32
    reg = scal_ref[0]
    radius = scal_ref[1]
    cols = pl.ds(pl.program_id(0) * block_g, block_g)
    gx = gx_ref[cols]                                        # [BG]
    slot = jax.lax.broadcasted_iota(jnp.int32, (nb_pad, block_g), 0)
    idx = start_ref[cols][None, :] + slot                    # [NBP, BG]
    valid = (slot < nb) & (idx < n_obs)
    idx = jnp.where(valid, idx, 0)
    z = jnp.abs(obsx_ref[idx] - gx[None, :]) / radius
    w = jnp.where(valid, _taper_poly(z, taper, epsilon), 0.0)
    sw = jnp.sqrt(w)
    yh = innov_ref[idx] * sw + poison_ref[cols][None, :]

    # one pass over the ensemble: Gram S [NBP, NBP, BG] and u_i = Zh sp_i
    def gram_body(kk, carry):
        s, us = carry
        zk = perts_ref[kk, idx] * sw                         # [NBP, BG]
        s = s + zk[:, None, :] * zk[None, :, :]
        us = tuple(u + zk * sp_ref[i, kk, cols][None, :]
                   for i, u in enumerate(us))
        return s, us

    zero = jnp.zeros((nb_pad, block_g), f32)
    s, us = jax.lax.fori_loop(
        0, ens_size, gram_body,
        (jnp.zeros((nb_pad, nb_pad, block_g), f32), (zero,) * ns))

    # spectral bound of X = I + S/reg and the per-column coefficients
    eye = (jax.lax.broadcasted_iota(jnp.int32, (nb_pad, nb_pad, 1), 0)
           == jax.lax.broadcasted_iota(jnp.int32, (nb_pad, nb_pad, 1), 1))
    inf_norm = jnp.max(jnp.sum(jnp.abs(s), axis=1), axis=0)  # [BG]
    trace = jnp.sum(jnp.sum(jnp.where(eye, s, 0.0), axis=1), axis=0)
    lam_ub = jnp.maximum(1.0 + jnp.minimum(inf_norm, trace) / reg, 1.05)
    half_w = 0.5 * (lam_ub - 1.0)
    nodes, dct = _cheb_coefficients(degree)
    f1 = []
    f2 = []
    for t in nodes:
        x = (1.0 + half_w) + half_w * t
        sq = jnp.sqrt(x)
        f1.append(1.0 / x)
        f2.append(1.0 / (sq * (1.0 + sq)))
    c1 = [sum(d * f for d, f in zip(row, f1)) for row in dct]  # [BG] each
    c2 = [sum(d * f for d, f in zip(row, f2)) for row in dct]
    a2 = (2.0 / (lam_ub - 1.0) / reg)[None, :]

    def xt(v):
        return a2 * jnp.sum(s * v[None, :, :], axis=1) - v

    # joint Clenshaw recurrence: operand 0 = yh with f1, 1.. = u_i with f2
    ops = (yh,) + us
    coef = [c1] + [c2] * ns
    b1 = [zero] * len(ops)
    b2 = [zero] * len(ops)
    for m in range(degree, 0, -1):
        b0 = [coef[j][m][None, :] * ops[j] + 2.0 * xt(b1[j]) - b2[j]
              for j in range(len(ops))]
        b2, b1 = b1, b0
    res = [coef[j][0][None, :] * ops[j] + xt(b1[j]) - b2[j]
           for j in range(len(ops))]
    q = res[0]                                              # X^{-1} yh
    vs = res[1:]                                            # f2(X) u_i

    alpha = jnp.sqrt((ens_size - 1.0) / reg)
    base = [mean_ref[i, cols] + jnp.sum(us[i] * q, axis=0) / reg
            for i in range(ns)]

    # weight application: one more pass over the ensemble, one output row
    # [BG] per member and slice
    def apply_body(kk, carry):
        zk = perts_ref[kk, idx] * sw
        for i in range(ns):
            zv = jnp.sum(zk * vs[i], axis=0)
            out_ref[i, kk, cols] = (base[i] + alpha * sp_ref[i, kk, cols]
                                    - (alpha / reg) * zv)
        return carry

    jax.lax.fori_loop(0, ens_size, apply_body, 0)


@functools.partial(
    jax.jit,
    static_argnames=("ens_size", "nb", "degree", "epsilon", "taper",
                     "interpret"),
)
def window_analysis_kernel(perts, innov, obs_x, grid_x, start, poison, sp,
                           mean, reg, radius, *, ens_size, nb, degree,
                           epsilon, taper, interpret=False):
    """The kernel's forward over the prologue's window ``start`` [G] and
    additive ``poison`` [G]: perts [k, o], innov [o], obs_x [o] sorted,
    grid_x [G], sp [ns, k, G], mean [ns, G] -> analysis [ns, k, G]."""
    f32 = jnp.float32
    ns, k, g = sp.shape
    o = obs_x.shape[0]
    nb_pad, block_g = block_shape(nb)
    n_blocks = -(-g // block_g)
    pad = n_blocks * block_g - g
    if pad:
        grid_x = jnp.pad(grid_x, (0, pad), mode="edge")
        start = jnp.pad(start, (0, pad), mode="edge")
        poison = jnp.pad(poison, (0, pad))
        sp = jnp.pad(sp, ((0, 0), (0, 0), (0, pad)))
        mean = jnp.pad(mean, ((0, 0), (0, pad)))
    scal = jnp.stack([jnp.asarray(reg, f32), jnp.asarray(radius, f32)])
    kernel = functools.partial(
        _kernel, ens_size=ens_size, ns=ns, nb=nb, nb_pad=nb_pad,
        block_g=block_g, n_obs=o, degree=degree, epsilon=epsilon,
        taper=taper)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((ns, k, g + pad), f32),
        grid=(n_blocks,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="letkf_window_1d",
    )(scal, grid_x.astype(f32), start.astype(jnp.int32),
      poison.astype(f32), perts.astype(f32), innov.astype(f32),
      obs_x.astype(f32), sp.astype(f32), mean.astype(f32))
    return out[:, :, :g]
