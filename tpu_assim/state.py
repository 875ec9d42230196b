"""
Ensemble model state.

JAX replacement for the reference's xarray accessor ``ModelState``
(/root/reference/pytassim/state.py:52-229): instead of a ``DataArray`` with a
MultiIndex grid, the state is a registered pytree holding one dense
``[var, time, ensemble, grid]`` array plus explicit coordinate arrays — the
whole thing traces through ``jit``/``vmap``/``shard_map`` with zero host
round-trips.

Dimension contract (identical to the reference, state.py:114):
``('var_name', 'time', 'ensemble', 'grid')``.

The reference's MultiIndex grid (e.g. multi-variable vertical columns) maps to
an explicit ``grid_coords [grid, n_coord]`` float array used by localization
distance functions (replacing utilities/pandas.py:70-102 ``index_to_array``).
"""

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["EnsembleState", "StateError"]


class StateError(Exception):
    """Raised when a state fails validation
    (reference: pytassim/state.py:44-49)."""


@jax.tree_util.register_pytree_node_class
class EnsembleState:
    """Dense ensemble state with coordinates.

    Parameters
    ----------
    data : [var, time, ensemble, grid] array.
    times : [time] float array of times (unix seconds or model time units).
    grid_coords : [grid, n_coord] float coordinates of the grid columns
        (used by localization distances). Defaults to ``arange(grid)[:, None]``.
    var_names : static tuple of variable names.
    ens_members : static tuple of ensemble-member labels.
    """

    def __init__(
        self,
        data,
        times=None,
        grid_coords=None,
        var_names: Optional[Tuple[str, ...]] = None,
        ens_members: Optional[Tuple[int, ...]] = None,
    ):
        data = jnp.asarray(data)
        if data.ndim != 4:
            raise StateError(
                "EnsembleState data must be 4-D (var, time, ensemble, grid), "
                "got shape {0}".format(data.shape)
            )
        n_var, n_time, n_ens, n_grid = data.shape
        self.data = data
        self.times = (
            jnp.arange(n_time, dtype=data.dtype)
            if times is None
            else jnp.asarray(times)
        )
        self.grid_coords = (
            jnp.arange(n_grid, dtype=data.dtype)[:, None]
            if grid_coords is None
            else jnp.atleast_2d(jnp.asarray(grid_coords).T).T
            if jnp.asarray(grid_coords).ndim == 1
            else jnp.asarray(grid_coords)
        )
        self.var_names = (
            tuple(var_names) if var_names is not None else tuple(range(n_var))
        )
        self.ens_members = (
            tuple(ens_members) if ens_members is not None else tuple(range(n_ens))
        )

    # ------------------------------------------------------------------ pytree
    def tree_flatten(self):
        return (self.data, self.times, self.grid_coords), (
            self.var_names,
            self.ens_members,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data, obj.times, obj.grid_coords = children
        obj.var_names, obj.ens_members = aux
        return obj

    def replace(self, data=None, times=None, grid_coords=None) -> "EnsembleState":
        obj = object.__new__(EnsembleState)
        obj.data = self.data if data is None else data
        obj.times = self.times if times is None else times
        obj.grid_coords = self.grid_coords if grid_coords is None else grid_coords
        obj.var_names = self.var_names
        obj.ens_members = self.ens_members
        return obj

    # ------------------------------------------------------------- properties
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_vars(self) -> int:
        return self.data.shape[0]

    @property
    def n_times(self) -> int:
        return self.data.shape[1]

    @property
    def ens_size(self) -> int:
        return self.data.shape[2]

    @property
    def n_grid(self) -> int:
        return self.data.shape[3]

    @property
    def valid(self) -> bool:
        """Validity check mirroring the reference accessor
        (pytassim/state.py:102-129): 4 dims in the contracted order with
        matching coordinate lengths."""
        try:
            ok = self.data.ndim == 4
            ok &= self.times.shape[0] == self.n_times
            ok &= self.grid_coords.shape[0] == self.n_grid
            ok &= len(self.var_names) == self.n_vars
            ok &= len(self.ens_members) == self.ens_size
            return bool(ok)
        except Exception:
            return False

    # ------------------------------------------------------------ ensemble ops
    def mean(self) -> jnp.ndarray:
        """Ensemble mean [var, time, 1, grid]."""
        return jnp.mean(self.data, axis=2, keepdims=True)

    def split_mean_perts(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Split into ensemble mean and perturbations
        (reference: pytassim/state.py:131-162)."""
        mean = self.mean()
        perts = self.data - mean
        return mean, perts

    # ---------------------------------------------------------- time selection
    def time_index(self, analysis_time: Optional[float]) -> int:
        """Host-side: index of the analysis time. ``None`` selects the last
        time, otherwise the nearest time (reference: interface/base.py:153-178
        uses ``sel(..., method='nearest')``)."""
        times = np.asarray(self.times)
        if analysis_time is None:
            return int(len(times) - 1)
        return int(np.argmin(np.abs(times - float(analysis_time))))

    def sel_time_index(self, idx: int) -> "EnsembleState":
        """Slice the state to a single analysis time (kept as length-1 dim,
        matching ``state.sel(time=[t])`` in interface/filter.py:46-47)."""
        return EnsembleState(
            self.data[:, idx : idx + 1],
            times=self.times[idx : idx + 1],
            grid_coords=self.grid_coords,
            var_names=self.var_names,
            ens_members=self.ens_members,
        )

    # -------------------------------------------------------------- arithmetic
    def _binop(self, other, op) -> "EnsembleState":
        if isinstance(other, EnsembleState):
            other = other.data
        return self.replace(data=op(self.data, other))

    def __add__(self, other):
        return self._binop(other, jnp.add)

    def __radd__(self, other):
        return self._binop(other, lambda a, b: jnp.add(b, a))

    def __sub__(self, other):
        return self._binop(other, jnp.subtract)

    def __mul__(self, other):
        return self._binop(other, jnp.multiply)

    def __rmul__(self, other):
        return self._binop(other, lambda a, b: jnp.multiply(b, a))

    def __truediv__(self, other):
        return self._binop(other, jnp.divide)

    def __repr__(self):
        return "EnsembleState(vars={0}, times={1}, ens={2}, grid={3})".format(
            self.n_vars, self.n_times, self.ens_size, self.n_grid
        )

    # ------------------------------------------------------- localization info
    def grid_info(self) -> jnp.ndarray:
        """Per-column coordinate rows for localization distances, with the
        first analysis time prepended as column 0 — preserving the reference
        behavior (pytassim/interface/mixin_local.py:49-69 prepends
        ``time[0].timestamp()``).

        Returns [grid, 1 + n_coord].
        """
        t0 = jnp.broadcast_to(
            self.times[0].astype(self.grid_coords.dtype), (self.n_grid, 1)
        )
        return jnp.concatenate([t0, self.grid_coords], axis=1)
