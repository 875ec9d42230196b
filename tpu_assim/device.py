"""
The one module that decides anything about the device the program runs on.

* :func:`setup_compile_cache` — JAX's persistent compilation cache, kept
  where ``JAX_COMPILATION_CACHE_DIR`` says, otherwise at one fixed path
  inside the checkout (``.jax_cache/``, git-ignored). The entry points
  (``bench.py``, ``chip_smoke.py``, ``__graft_entry__.py``) call it first.
* :func:`require_gpu` — the measurement entry points run on a GPU or not
  at all: a timing taken on the CPU backend is not a device number.
* :func:`device_info` — the platform, ``device_kind`` and device count that
  every benchmark row carries.
* :func:`kernel_or_plain` — where a computation runs a hand-written GPU
  kernel and where its plain XLA twin.
"""

import os
from pathlib import Path

__all__ = ["CACHE_DIR", "setup_compile_cache", "require_gpu", "device_info",
           "kernel_or_plain"]

#: The compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset. A
#: fixed path: the cache key includes it, so a moving directory never hits.
CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself; nothing else is configured), else
    at :data:`CACHE_DIR`. Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_info`, or ``RuntimeError`` when the default backend is
    not a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); device timings need the GPU"
        )
    return info


def kernel_or_plain(kernel, plain, *args, interpret: bool = False):
    """``kernel(*args)`` where the computation is lowered for a CUDA GPU,
    ``plain(*args)`` where it is lowered for the CPU (the test platform, an
    explicit choice: the kernel has no CPU compilation), and an error on any
    other platform. ``interpret=True`` — only when a caller asks — runs the
    kernel through the Pallas interpreter instead, on any platform.

    The choice is made per lowering (``jax.lax.platform_dependent``), so it
    follows where the arrays live, not which backend is the default."""
    import jax

    if interpret:
        return kernel(*args, interpret=True)
    return jax.lax.platform_dependent(*args, cpu=plain, cuda=kernel)
