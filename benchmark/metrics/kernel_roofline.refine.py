"""The refinement kernels' share of their roofline: the least time of
every traced launch of K1-K8 (benchmark/workcount.py, by the wrapper
that launched it) over their device time in the trace, in %."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "refine" or not t or t["kernel_ms"] <= 0:
        return None
    return 100.0 * t["kernel_bound_ms"] / t["kernel_ms"]
