"""The traced part of a `--trace 1` run: torch.profiler around a few
frames or steps (tracing off in the measured window), the ops attributed
by benchmark/attribution.py, and the breakdown the result line carries."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from benchmark import attribution

# seconds the profiler runs before the traced work: on an H100 the first
# kernels launched right after it started went missing without it
SETTLE_S = 0.2


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device, with_stack: bool = True):
    """(the profile of fn(), fn's wall seconds to its last synchronise);
    with_stack records the Python frames the attribution reads, which
    costs host time on every op."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts, with_stack=with_stack) as prof:
        if device.type == "cuda":
            time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    return prof, wall


def summarize(ops, wall_s: float) -> dict:
    """busy_s (the union of the device ops' spans), window_s, and the
    breakdown: the device ops that took most time, by kernel name, and
    the longest idle gaps between device ops, by the launcher of the op
    that ended each."""
    busy_ms = sum(o.ms for o in ops)
    by_name = defaultdict(float)
    for o in ops:
        by_name[o.name] += o.ms / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    order = sorted(ops, key=lambda o: o.start_ns)
    gaps, end = [], None
    for o in order:
        if end is not None and o.start_ns > end:
            label = f"before {o.opcode or o.name}"[:120]
            gaps.append([label, (o.start_ns - end) / 1e9])
        end = o.end_ns if end is None else max(end, o.end_ns)
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_ms / 1e3, "window_s": wall_s,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": gaps[:10]}}


def load(prof, reference=None):
    """Attributed ops of a profile: (ops, phases ms)."""
    ops, _, _ = attribution.load_ops(prof)
    phases, _ = attribution.attribute(ops, reference)
    return ops, phases
