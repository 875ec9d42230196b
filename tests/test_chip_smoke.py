"""chip_smoke.py's phases at tiny sizes on the CPU: the control flow,
shapes and oracle comparisons that the GPU run relies on, plus the device
and compile-cache helpers of tpu_assim.device."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def headline():
    from bench import numpy_reference_letkf

    w, nb = cs.headline_setup(ens=8, g=240, o=48)
    ref = numpy_reference_letkf(*w, radius=cs.RADIUS, inf_factor=cs.INF,
                                max_points=120)[0]
    return w, nb, ref


def _assert_ok(row):
    assert row["ok"], row
    assert row["finite"] and row["max_rel_err"] <= cs.TOL


def test_phase_headline(headline):
    row = cs.phase_headline(*headline)
    _assert_ok(row)
    assert row["compile_s"] > 0 and row["step_ms"] > 0
    assert "temp_size_in_bytes" in row["memory"]


@pytest.mark.parametrize("method", ["eigh", "fused1d"])
def test_phase_class_api(headline, method):
    w, nb, ref = headline
    _assert_ok(cs.phase_class_api(w, ref, method, nb))


def test_phase_cycle(headline):
    w, nb, _ = headline
    row = cs.phase_cycle(w, nb, n_cycles=2)
    _assert_ok(row)
    assert len(row["per_cycle_rel_err"]) == 2


def test_phase_lienks(headline):
    w, nb, _ = headline
    row = cs.phase_lienks(w, nb, reduced=(120, 24))
    _assert_ok(row)


def test_phase_dense_solvers():
    row = cs.phase_dense_solvers(batch=16, ks=(8, 12))
    assert row["ok"], row
    assert set(row["solvers"]) == {"eigh_[16,8,8]", "svd_[16,8,8]",
                                   "eigh_[16,12,12]", "svd_[16,12,12]"}


def test_phase_deployment():
    w, stencil, nb, cols = cs.deployment_setup(ens=10, g=512, o=64)
    ref = cs.deployment_oracle(w, stencil, cols)
    _assert_ok(cs.phase_deployment(w, stencil, nb, cols, ref))


def test_phase_fused2d():
    _assert_ok(cs.phase_fused2d(n=24, o=96, radius=3.0))


def test_phase_strip2d():
    row = cs.phase_strip2d(n=48, o=300, n_strips=2, radius=3.0)
    _assert_ok(row)
    assert row["shape"]["n_strips"] == 2


@pytest.mark.parametrize("phase, kwargs", [
    ("phase_four_halo_1d", dict(ens=8, cols_per_card=64, obs_per_card=16)),
    ("phase_four_halo_2d", dict(ens=8, side=32, n_obs=64, radius=2.0)),
    ("phase_four_sharded_letkf", dict(ens=8, cols_per_card=64, n_obs=32)),
    ("phase_four_lienks", dict(ens=8, cols_per_card=64, n_obs=32)),
])
def test_four_card_phase_on_virtual_devices(monkeypatch, phase, kwargs):
    """The --four phases on four of the eight virtual CPU devices: each
    sharded program against the same program on one device. The IEnKS
    runs with a small eigh chunk limit, so its batch is split on every
    device as it is on the cards."""
    from tpu_assim.ops import linalg

    monkeypatch.setattr(linalg, "EIGH_MAX_ROWS", 8 * 64)
    row = getattr(cs, phase)(n_dev=4, **kwargs)
    _assert_ok(row)
    assert len(row["bytes_in_use_per_device"]) == 4


def test_main_fails_without_gpu(capsys):
    """No GPU: the script raises before any phase and prints no result."""
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok": true' not in capsys.readouterr().out


def test_nvidia_smi_line_is_a_string():
    assert isinstance(cs.nvidia_smi(), str)


def test_report_records_failures():
    report = cs.Report()
    report.run("good", lambda: {"ok": True})
    assert report.ok
    row = report.run("bad", lambda: 1 / 0)
    assert not report.ok and "ZeroDivisionError" in row["error"]


def test_require_gpu_raises_on_cpu():
    from tpu_assim.device import device_info, require_gpu

    assert device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is configured;
    without it the cache is the fixed .jax_cache/ in the checkout."""
    import jax

    from tpu_assim import device

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(device, "CACHE_DIR", tmp_path / ".jax_cache")
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "env"))
            assert device.setup_compile_cache() == str(tmp_path / "env")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = device.setup_compile_cache()
            assert path == str(tmp_path / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert (tmp_path / ".jax_cache").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_fixed_and_ignored():
    from tpu_assim.device import CACHE_DIR

    root = Path(__file__).resolve().parents[1]
    assert CACHE_DIR == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()
