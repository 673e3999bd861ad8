"""Seconds a refinement frame: the whole window over the frames completed
in it, closed loop (host clock)."""


def read(run):
    if run["kind"] != "refine" or not run["frame_latencies"]:
        return None
    return run["window_s"] / len(run["frame_latencies"])
