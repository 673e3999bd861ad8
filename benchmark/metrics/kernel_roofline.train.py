"""The training step's field kernels' share of their roofline: the least
time of the traced steps' K5, K6 +dW and dW work (benchmark/workcount.py)
over the device time of the kernels the program's wrappers launched, in
%."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or t["kernel_ms"] <= 0:
        return None
    return 100.0 * t["kernel_bound_ms"] / t["kernel_ms"]
