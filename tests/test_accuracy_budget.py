"""
Accuracy-budget regression: the f32 fused paths carry a MEASURED error
bound vs the float64 per-column eigh oracle (the reference's default
precision, pytassim/interface/base.py:73), committed in docs/solvers.md.
CI fails if a change regresses the bound.

The same sweep (scripts/accuracy_sweep.py) runs compiled on the GPU through
``chip_smoke.py``. Measured values sit at the f32 input-representation
floor (~3e-7); the committed bounds leave ~30x headroom for benign
reassociation differences, NOT for truncation bugs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.accuracy_sweep import main as sweep_main  # noqa: E402

BOUNDS = {
    "fused1d deg12 (headline)": 1e-5,
    "fused1d deg16 (headline)": 1e-5,
    "cheb deg12 window (headline)": 1e-5,
    "fused2d deg12 (128x128)": 1e-5,
    "fused2d deg16 (128x128)": 1e-5,
    "fused1d smoother 4x-stack (auto degree)": 1e-5,
    "halo window (8 dev)": 1e-5,
    "strip2d (256x256, 4 strips)": 1e-5,
    "large ens100 (2^16 cols, 4pt-mean H)": 1e-5,
}


@pytest.fixture(scope="module")
def sweep_rows():
    return {r["config"]: r["max_rel_err"]
            for r in sweep_main(n_sample=96, full=False)}


@pytest.mark.parametrize("config", sorted(BOUNDS))
def test_fused_error_within_committed_bound(sweep_rows, config):
    assert config in sweep_rows
    err = sweep_rows[config]
    assert err < BOUNDS[config], (
        f"{config}: measured fused-vs-f64-oracle error {err:.3e} exceeds "
        f"the committed budget {BOUNDS[config]:.0e} (docs/solvers.md) — a "
        "kernel change regressed accuracy"
    )
