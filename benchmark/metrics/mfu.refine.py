"""A frame's model FLOPs (counted from shapes by the benchmark) over the
window's seconds a frame times the H100's 989 TFLOP/s dense bf16, in
%."""

PEAK = 989e12


def read(run):
    t = run.get("trace")
    if run["kind"] != "refine" or not t or not run["frame_latencies"]:
        return None
    frame_s = run["window_s"] / len(run["frame_latencies"])
    return 100.0 * t["model_flops_per_frame"] / (frame_s * PEAK)
