"""
Kernel base classes with operator composition.

JAX rebuild of the reference kernel family
(/root/reference/pytassim/kernels/base_kernels.py:39-161): kernels are
callable pytrees (parameters are leaves, so kernels trace cleanly through
``jit``/``vmap``/``grad``), composable with ``+``, ``*`` and ``**``.
"""

import jax
import jax.numpy as jnp

__all__ = [
    "BaseKernel",
    "CompKernel",
    "AdditiveKernel",
    "MultiplicativeKernel",
    "PowerKernel",
]


class BaseKernel:
    """Base class for all kernels. Subclasses implement ``forward(x, y)`` over
    the trailing (samples x features) dims and register themselves as pytrees
    via :func:`register_kernel`."""

    # --- pytree protocol -------------------------------------------------
    # Subclasses list their array-leaf attribute names here.
    _leaves: tuple = ()

    def tree_flatten(self):
        children = tuple(getattr(self, name) for name in self._leaves)
        return children, None

    @classmethod
    def tree_unflatten(cls, aux_data, children):
        obj = object.__new__(cls)
        for name, child in zip(cls._leaves, children):
            setattr(obj, name, child)
        return obj

    # --- composition (reference: kernels/base_kernels.py:46-53) ----------
    def __add__(self, other):
        return AdditiveKernel(self, other)

    def __mul__(self, other):
        return MultiplicativeKernel(self, other)

    def __pow__(self, other):
        return PowerKernel(self, other)

    def __call__(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        return self.forward(x, y)

    def forward(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError("Kernel must implement forward(x, y)")


def register_kernel(cls):
    """Class decorator: register a kernel as a JAX pytree."""
    jax.tree_util.register_pytree_node(
        cls,
        cls.tree_flatten,
        cls.tree_unflatten,
    )
    return cls


class CompKernel(BaseKernel):
    """Composition of two kernels (reference: kernels/base_kernels.py:60-78)."""

    _leaves = ("kernel_1", "kernel_2")

    def __init__(self, kernel_1: BaseKernel, kernel_2: BaseKernel):
        self.kernel_1 = kernel_1
        self.kernel_2 = kernel_2


@register_kernel
class AdditiveKernel(CompKernel):
    """``K1(x,y) + K2(x,y)`` (reference: kernels/base_kernels.py:81-105)."""

    def forward(self, x, y):
        return self.kernel_1(x, y) + self.kernel_2(x, y)


@register_kernel
class MultiplicativeKernel(CompKernel):
    """``K1(x,y) * K2(x,y)`` (reference: kernels/base_kernels.py:108-133)."""

    def forward(self, x, y):
        return self.kernel_1(x, y) * self.kernel_2(x, y)


@register_kernel
class PowerKernel(CompKernel):
    """``K1(x,y) ** K2(x,y)`` (reference: kernels/base_kernels.py:136-161)."""

    def forward(self, x, y):
        return self.kernel_1(x, y) ** self.kernel_2(x, y)
