"""A training step's model FLOPs (counted from shapes by the benchmark)
over the window's seconds a step times the H100's 989 TFLOP/s dense
bf16, in %."""

PEAK = 989e12


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not run["steps"]:
        return None
    step_s = run["window_s"] / run["steps"]
    return 100.0 * t["model_flops_per_step"] / (step_s * PEAK)
