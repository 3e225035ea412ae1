"""Profiling helpers: the accelerator-native answer to the reference's logging/
criterion observability (SURVEY.md §5 — the reference has only the `log`
facade and a criterion bench; here every solver phase is wrapped in
``jax.named_scope`` so device traces attribute time to `lbfgs.line_search`,
`lbfgs.pair_gram_update`, `lbfgs.two_loop`, ... out of the box).

Usage::

    from lbfgs_jax.utils.profiling import trace, timed

    with trace("/tmp/lbfgs-trace"):        # view in xprof/tensorboard
        report = lbfgs().minimize_jit(x0, objective)

    dt = timed(lambda: lbfgs().minimize_jit(x0, objective))
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

import jax


@contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a device/host profiler trace of the enclosed block.

    Writes a TensorBoard/xprof-compatible trace under ``logdir``; the
    solver's ``named_scope`` phases appear as labeled spans.
    """
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _sync(result) -> None:
    """Force completion of ``result`` by materializing one scalar per leaf."""
    for leaf in jax.tree.leaves(result):
        if hasattr(leaf, "ravel") and getattr(leaf, "size", 0):
            float(leaf.ravel()[0])


def timed(fn: Callable[[], object], warmup: int = 1, repeats: int = 1) -> float:
    """Steady-state wall time of ``fn()`` in seconds (best of ``repeats``).

    Runs ``warmup`` untimed calls first so compilation and cache effects
    are excluded — the criterion-equivalent measurement discipline
    (reference ``benches/rosenbrock.rs``).
    """
    for _ in range(warmup):
        _sync(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best
