"""Device kernels a replayed refinement iteration launches (the captured
iteration's kernels in the trace over its replays)."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "refine" or not t or not t["replays"]:
        return None
    return t["replayed_kernels"] / t["replays"]
