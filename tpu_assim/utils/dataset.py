"""
Minimal labeled-dataset layer (host-side, numpy).

The reference leans on xarray for its real-model adapters
(/root/reference/pytassim/model/terrsysmp/common.py) and on pandas
MultiIndexes for stacked grids (pytassim/state.py:164-222). xarray is a poor
fit for a device pipeline (lazy graphs, object coords, host-bound), so this
module provides the few labeled operations the adapters actually need —
variables with named dims, coordinate arrays, reindex-by-value, dim renaming,
stacking — over plain contiguous numpy arrays. Stacked grids keep an explicit
``[grid, n_coord]`` float coordinate matrix (consumed directly by
localization distances) instead of a MultiIndex.
"""

from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np

__all__ = ["Variable", "Dataset"]


class Variable:
    """A named-dimension numpy array: ``dims`` is a tuple of dim names
    matching ``values.ndim``."""

    def __init__(self, dims: Sequence[str], values: np.ndarray):
        values = np.asarray(values)
        dims = tuple(dims)
        if len(dims) != values.ndim:
            raise ValueError(
                "dims {0} do not match array rank {1}".format(
                    dims, values.ndim
                )
            )
        self.dims = dims
        self.values = values

    def copy(self) -> "Variable":
        return Variable(self.dims, self.values.copy())

    @property
    def shape(self):
        return self.values.shape

    def transpose(self, order: Sequence[str]) -> "Variable":
        """Reorder to the dims in ``order`` (must be a permutation)."""
        order = tuple(order)
        if set(order) != set(self.dims):
            raise ValueError(
                "transpose order {0} != dims {1}".format(order, self.dims)
            )
        axes = [self.dims.index(d) for d in order]
        return Variable(order, self.values.transpose(axes))

    def expand_dims(self, dim: str, axis: int = 0, size: int = 1) -> "Variable":
        vals = np.expand_dims(self.values, axis)
        if size != 1:
            vals = np.broadcast_to(
                vals, vals.shape[:axis] + (size,) + vals.shape[axis + 1:]
            ).copy()
        dims = list(self.dims)
        dims.insert(axis if axis >= 0 else len(dims) + 1 + axis, dim)
        return Variable(tuple(dims), vals)

    def rename_dim(self, old: str, new: str) -> "Variable":
        return Variable(
            tuple(new if d == old else d for d in self.dims), self.values
        )

    def __repr__(self):
        return "Variable(dims={0}, shape={1})".format(self.dims, self.shape)


class Dataset:
    """Dict of :class:`Variable` + 1-D coordinate arrays keyed by dim name.

    Only the operations needed by the TerrSysMP adapters are implemented;
    each mirrors the xarray call used by the reference (cited at the call
    sites in models/terrsysmp/*).
    """

    def __init__(
        self,
        data_vars: Mapping[str, Variable],
        coords: Optional[Mapping[str, np.ndarray]] = None,
        attrs: Optional[dict] = None,
    ):
        self.data_vars: Dict[str, Variable] = dict(data_vars)
        self.coords: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in (coords or {}).items()
        }
        self.attrs = dict(attrs or {})
        for name, var in self.data_vars.items():
            for d, n in zip(var.dims, var.shape):
                if d in self.coords and len(self.coords[d]) != n:
                    raise ValueError(
                        "variable {0}: dim {1} has size {2} but coord has "
                        "length {3}".format(name, d, n, len(self.coords[d]))
                    )

    # ------------------------------------------------------------- basics
    def copy(self, deep: bool = False) -> "Dataset":
        return Dataset(
            {k: (v.copy() if deep else Variable(v.dims, v.values))
             for k, v in self.data_vars.items()},
            {k: (v.copy() if deep else v) for k, v in self.coords.items()},
            dict(self.attrs),
        )

    def __getitem__(self, name: str) -> Variable:
        return self.data_vars[name]

    def __setitem__(self, name: str, var: Variable):
        self.data_vars[name] = var

    def __contains__(self, name: str) -> bool:
        return name in self.data_vars

    @property
    def dims(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for var in self.data_vars.values():
            for d, n in zip(var.dims, var.shape):
                out[d] = n
        return out

    def select(self, names: Iterable[str]) -> "Dataset":
        """Subset of variables (xarray ``ds[vars]``)."""
        sel = {n: self.data_vars[n] for n in names if n in self.data_vars}
        used = {d for v in sel.values() for d in v.dims}
        return Dataset(
            sel, {k: v for k, v in self.coords.items() if k in used},
            dict(self.attrs),
        )

    # ------------------------------------------------------ labeled reindex
    def reindex(self, dim: str, new_values: np.ndarray) -> "Dataset":
        """Reindex ``dim`` onto ``new_values`` by exact coordinate match,
        filling unmatched positions with NaN (xarray
        ``ds.reindex(dim=new_values, method=None)``, used by the COSMO/CLM
        vertical-grid interpolation, terrsysmp/cosmo.py:155-168)."""
        new_values = np.asarray(new_values)
        old = self.coords.get(dim)
        if old is None:
            raise KeyError("no coordinate for dim {0}".format(dim))
        # match new positions to old positions by value
        src = np.full(len(new_values), -1, dtype=np.int64)
        for j, val in enumerate(new_values):
            hits = np.nonzero(old == val)[0]
            if hits.size:
                src[j] = hits[0]
        out_vars = {}
        for name, var in self.data_vars.items():
            if dim not in var.dims:
                out_vars[name] = var
                continue
            ax = var.dims.index(dim)
            taken = np.take(var.values, np.maximum(src, 0), axis=ax)
            mask_shape = [1] * taken.ndim
            mask_shape[ax] = len(new_values)
            mask = (src < 0).reshape(mask_shape)
            vals = np.where(mask, np.nan, taken)
            out_vars[name] = Variable(var.dims, vals)
        coords = dict(self.coords)
        coords[dim] = new_values
        return Dataset(out_vars, coords, dict(self.attrs))

    def rename_dims(self, mapping: Mapping[str, str],
                    drop_old_coords: bool = True) -> "Dataset":
        """Rename dims (xarray ``reset_index + rename``,
        terrsysmp/common.py:72-83). When several old dims map to the same new
        name the variables must not share them."""
        out_vars = {
            name: _rename_var(var, mapping)
            for name, var in self.data_vars.items()
        }
        coords = {}
        for k, v in self.coords.items():
            if k in mapping:
                if not drop_old_coords:
                    coords[mapping[k]] = v
            else:
                coords[k] = v
        return Dataset(out_vars, coords, dict(self.attrs))

    def __repr__(self):
        return "Dataset(vars={0}, dims={1})".format(
            list(self.data_vars), self.dims
        )


def _rename_var(var: Variable, mapping: Mapping[str, str]) -> Variable:
    new_dims = tuple(mapping.get(d, d) for d in var.dims)
    if len(set(new_dims)) != len(new_dims):
        raise ValueError(
            "renaming {0} collides on variable dims {1}".format(
                dict(mapping), var.dims
            )
        )
    return Variable(new_dims, var.values)
