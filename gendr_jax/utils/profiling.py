"""jax.profiler integration.

The reference has no tracing/profiling subsystem (SURVEY.md §5: wall-clock
meters only); the XLA profiler traces the device — wrap any region in
``trace(log_dir)`` and inspect with TensorBoard / xprof.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
