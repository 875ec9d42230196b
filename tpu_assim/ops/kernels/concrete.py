"""
Concrete kernel family.

JAX rebuild of the ten reference kernels
(/root/reference/pytassim/kernels/): pure jnp math, parameters as pytree
leaves. The math of each kernel is cited to its reference file.
"""

import jax.numpy as jnp

from tpu_assim.ops.kernels.base import BaseKernel, register_kernel
from tpu_assim.ops.kernels.utils import dot_product, distance_matrix, euclidean_dist

__all__ = [
    "LinearKernel",
    "GaussKernel",
    "RBFKernel",
    "PolyKernel",
    "PeriodicKernel",
    "RationalKernel",
    "TanhKernel",
    "OrnsteinUhlenbeckKernel",
    "ScaleKernel",
    "DiagKernel",
    "ModuleKernel",
]


def _as_array(value):
    return jnp.asarray(value)


@register_kernel
class LinearKernel(BaseKernel):
    """``K(x, y) = x y^T`` (reference: kernels/linear.py:43-67)."""

    _leaves = ()

    def __init__(self):
        pass

    def forward(self, x, y):
        return dot_product(x, y)


@register_kernel
class GaussKernel(BaseKernel):
    """``K(x, y) = exp(-||x-y||^2 / (2 l^2))`` (reference: kernels/rbf.py:44-81)."""

    _leaves = ("lengthscale",)

    def __init__(self, lengthscale=1.0):
        self.lengthscale = _as_array(lengthscale)

    def _get_lengthscale(self):
        return self.lengthscale

    def forward(self, x, y):
        ls = self._get_lengthscale()
        euc = euclidean_dist(x / ls, y / ls)
        return jnp.exp(-euc / 2.0)


@register_kernel
class RBFKernel(GaussKernel):
    """Gauss kernel reparametrized by ``gamma``: ``l = (0.5/gamma)^0.5``
    (reference: kernels/rbf.py:84-111)."""

    _leaves = ("gamma",)

    def __init__(self, gamma=0.5):
        self.gamma = _as_array(gamma)

    def _get_lengthscale(self):
        return (0.5 / self.gamma) ** 0.5


@register_kernel
class PolyKernel(BaseKernel):
    """``K(x, y) = (x y^T + c)^p`` (reference: kernels/polynomial.py:43-82)."""

    _leaves = ("degree", "const")

    def __init__(self, degree=2.0, const=1.0):
        self.degree = _as_array(degree)
        self.const = _as_array(const)

    def forward(self, x, y):
        return (dot_product(x, y) + self.const) ** self.degree


@register_kernel
class PeriodicKernel(BaseKernel):
    """``K(x, y) = exp(-2 sin^2(pi ||x-y||_1 / p) / l^2)``
    (reference: kernels/periodic.py:46-85)."""

    _leaves = ("period", "lengthscale")

    def __init__(self, period=jnp.pi, lengthscale=1.0):
        self.period = _as_array(period)
        self.lengthscale = _as_array(lengthscale)

    def forward(self, x, y):
        dist_mat = distance_matrix(x, y, 1.0) * jnp.pi / self.period
        factor = -2.0 * jnp.square(jnp.sin(-dist_mat)) / (self.lengthscale**2)
        return jnp.exp(factor)


@register_kernel
class RationalKernel(BaseKernel):
    """Rational-quadratic ``K(x, y) = (1 + ||x-y||^2 / (2 a l^2))^{-a}``
    (reference: kernels/rational.py:44-88)."""

    _leaves = ("lengthscale", "weighting")

    def __init__(self, lengthscale=1.0, weighting=1.0):
        self.lengthscale = _as_array(lengthscale)
        self.weighting = _as_array(weighting)

    def forward(self, x, y):
        euc = euclidean_dist(x / self.lengthscale, y / self.lengthscale)
        factor = 1.0 + euc / (2.0 * self.weighting)
        return factor ** (-self.weighting)


@register_kernel
class TanhKernel(BaseKernel):
    """``K(x, y) = tanh(alpha x y^T + c)`` (reference: kernels/tanh.py:44-87)."""

    _leaves = ("coeff", "const")

    def __init__(self, coeff=1.0, const=1.0):
        self.coeff = _as_array(coeff)
        self.const = _as_array(const)

    def forward(self, x, y):
        return jnp.tanh(self.coeff * dot_product(x, y) + self.const)


@register_kernel
class OrnsteinUhlenbeckKernel(BaseKernel):
    """``K(x, y) = exp(-||x-y||_1 / l)`` (reference: kernels/orn_uhl.py:44-76)."""

    _leaves = ("lengthscale",)

    def __init__(self, lengthscale=1.0):
        self.lengthscale = _as_array(lengthscale)

    def forward(self, x, y):
        abs_dist = distance_matrix(x, y, norm=1.0)
        return jnp.exp(-abs_dist / self.lengthscale)


@register_kernel
class ScaleKernel(BaseKernel):
    """Constant kernel ``K(x, y) = c`` (reference: kernels/scale.py:43-74)."""

    _leaves = ("scaling",)

    def __init__(self, scaling=1.0):
        self.scaling = _as_array(scaling)

    def forward(self, x, y):
        shape = jnp.broadcast_shapes(x.shape[:-1] + (y.shape[-2],))
        return jnp.ones(shape, dtype=x.dtype) * self.scaling


@register_kernel
class DiagKernel(BaseKernel):
    """White-noise kernel ``c * I`` for equal sample counts, zero matrix
    otherwise (reference: kernels/diag.py:43-73)."""

    _leaves = ("scaling",)

    def __init__(self, scaling=1.0):
        self.scaling = _as_array(scaling)

    def forward(self, x, y):
        n_x, n_y = x.shape[-2], y.shape[-2]
        shape = x.shape[:-1] + (n_y,)
        if n_x != n_y:
            return jnp.zeros(shape, dtype=x.dtype)
        eye = jnp.eye(n_x, dtype=x.dtype)
        return jnp.broadcast_to(eye, shape) * self.scaling


@register_kernel
class ModuleKernel(BaseKernel):
    """Feature-map kernel ``K(x, y) = phi(x) phi(y)^T`` with an arbitrary
    callable feature map (random features, NN featurizers)
    (reference: kernels/module_kernel.py:43-80). The transform is treated as a
    pytree leaf, so flax/haiku apply-functions with bound params work."""

    _leaves = ("transform",)

    def __init__(self, transform):
        self.transform = transform

    def forward(self, x, y):
        x_net = self.transform(x)
        y_net = self.transform(y)
        return dot_product(x_net, y_net)
