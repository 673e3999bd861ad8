"""Profiling hooks: a torch.profiler trace and device-synchronised phase
timers; port of nefes_tpu/utils/profiling.py (the reference's
PROFILE_TIME prints and cuda-sync timer pair, script/models/
rendering.py:18,260-268; DFM_APR_refine.py:25-39).

``trace(dir)`` records the CPU and, on a card, the CUDA activity of its
block and writes it as a Chrome trace (dir/trace.json, chrome://tracing
or Perfetto); ``PhaseTimer`` sums named wall-clock phases. Every timer
synchronises the device (when CUDA is in use) before it reads the clock,
since PyTorch returns before the device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block, written to log_dir/trace.json; no-op
    when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Wall-clock per named phase, the device synchronised at its end.

    with timer.phase("render"): ...
    print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, out=None):
        if self.sync:
            _sync()
        t0 = time.perf_counter()
        yield
        if self.sync:
            _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / n * 1e3:.2f} ms/call"
                         f" x{n}")
        return "\n".join(lines)


def start_timer() -> float:
    """Reference start_timer parity (DFM_APR_refine.py:25-32)."""
    _sync()
    return time.perf_counter()


def end_timer_and_print(t0: float, label: str = "") -> float:
    """Reference end_timer_and_print parity (:34-39), with the device's
    peak memory when CUDA is in use. Returns seconds."""
    _sync()
    dt = time.perf_counter() - t0
    mem = ""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        mem = (f"  peak device memory: "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"Total execution time = {dt:.3f} sec {label}{mem}", flush=True)
    return dt
