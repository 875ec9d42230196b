"""
Tracing / profiling utilities.

The reference's only observability is a wall-clock log line around
``assimilate`` (/root/reference/pytassim/interface/base.py:471,508-511) and
CSV timings in benchmark scripts (examples/benchmark_efficiency.py:120-142).
Here (SURVEY §5.1): named phase timers with a process-wide registry, a
``jax.profiler`` trace context for real XLA device timelines, and annotated
trace spans that show up in both.

Usage::

    from tpu_assim.utils.profiling import phase, report, trace

    with phase("forecast"):
        state = step(state)
    with phase("analysis"):
        analysis = analyse(...)
    print(report())

    with trace("/tmp/jax-trace"):       # open in XProf/TensorBoard
        analysis = analyse(...)
"""

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import jax

logger = logging.getLogger(__name__)

__all__ = ["phase", "report", "reset", "timings", "trace"]

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str, block: bool = False) -> Iterator[None]:
    """Time a named phase (accumulating over calls).

    Inside jit nothing is timed (tracing happens once); use around jitted
    calls. With ``block=True`` the timer waits for all pending device work
    via ``jax.block_until_ready`` on nothing — pass explicitly-blocked
    outputs for exact device timings instead.
    """
    named = jax.named_scope(name)  # shows up in XLA traces too
    start = time.perf_counter()
    with named:
        yield
    if block:
        jax.effects_barrier()
    elapsed = time.perf_counter() - start
    with _lock:
        _totals[name] += elapsed
        _counts[name] += 1
    logger.debug("phase %s: %.3f ms", name, elapsed * 1e3)


def timings() -> Dict[str, Dict[str, float]]:
    """Snapshot of accumulated phase timings."""
    with _lock:
        return {
            name: {
                "total_s": _totals[name],
                "count": _counts[name],
                "mean_ms": 1e3 * _totals[name] / max(_counts[name], 1),
            }
            for name in _totals
        }


def report() -> str:
    """Human-readable phase report."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total_s"])
    lines = ["{0:<28} {1:>10} {2:>12} {3:>10}".format(
        "phase", "calls", "total [s]", "mean [ms]")]
    for name, row in rows:
        lines.append("{0:<28} {1:>10d} {2:>12.3f} {3:>10.3f}".format(
            name, row["count"], row["total_s"], row["mean_ms"]))
    return "\n".join(lines)


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2) -> Iterator[None]:
    """``jax.profiler`` trace context: writes an XLA device timeline viewable
    in XProf / TensorBoard (the strict upgrade over the reference's
    wall-clock logging, SURVEY §5.1)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
