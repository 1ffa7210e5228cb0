"""Tracing/profiling (SURVEY.md §5.1 — the reference has none; the port
exposes torch.profiler traces plus lightweight phase timers).

Usage:
    with trace("/tmp/bpg-trace"):        # open in Perfetto / chrome://tracing
        prove(...)

    with phase_timings() as timings:
        prove(...)
    # timings: {"phase": seconds, ...}
"""
import contextlib
import os
import time
from collections import defaultdict

_current = None


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block: host activity, and the GPU's
    kernels and copies where CUDA is available.  Writes a Chrome trace,
    `log_dir/trace-<pid>-<ns>.json`; yields the profiler (key_averages()
    for sums by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall time into the active phase_timings() collector."""
    global _current
    t0 = time.time()
    try:
        yield
    finally:
        if _current is not None:
            _current[name] += time.time() - t0


@contextlib.contextmanager
def phase_timings():
    global _current
    prev = _current
    _current = defaultdict(float)
    try:
        yield _current
    finally:
        _current = prev
