"""Tracing / profiling instrumentation.

The reference has none — not even ``time.time()`` (SURVEY.md §6). Here:
``jax.named_scope`` around the hot phases so profiler traces show
kernel-build / factorize / solve as named regions, ``jax.profiler.trace``
for on-demand trace capture, ``block_until_ready``-bracketed wall-clock
timers for device timings in the bench harness, and the persistent
compile-cache switch every entry point shares.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import jax


# Re-export: annotate compiled regions; shows up in xprof/XLA HLO metadata.
named_scope = jax.named_scope


def enable_persistent_compile_cache() -> str:
    """Turn on XLA's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing. Otherwise the cache goes to ``.jax_cache`` at the root of
    the checkout, whatever the caller's working directory. Every entry
    point (bench.py, chip_smoke.py, the examples) calls this first."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cache_dir = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace viewable in XProf/TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _block(x: Any) -> None:
    jax.tree_util.tree_map(
        lambda leaf: leaf.block_until_ready() if hasattr(leaf, "block_until_ready") else leaf,
        x,
    )


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    iters: int = 5,
    **kwargs: Any,
) -> Dict[str, float]:
    """Wall-clock a (usually jitted) function with compile excluded.

    Runs ``warmup`` untimed calls (first one pays compilation), then ``iters``
    timed calls, each bracketed by ``block_until_ready`` so asynchronous
    dispatch can't fake a fast time. Returns mean/min/std seconds.

    """
    for _ in range(max(warmup, 1)):
        _block(fn(*args, **kwargs))
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    return {"mean_s": mean, "min_s": min(times), "std_s": var ** 0.5, "iters": n}


class Stopwatch:
    """Accumulating named phase timer for host-side orchestration code."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *, block: Optional[Any] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                _block(block)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in self.totals
        }
