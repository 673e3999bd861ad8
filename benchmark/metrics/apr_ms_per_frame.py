"""Device ms a frame of the APR's forward and backward: the traced ops
that the attribution ties to the APR's modules inside the refinement
and, in mode 3, the initial pose (the target features' extraction left
out)."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "refine" or not t or t["apr_ms"] <= 0:
        return None
    return t["apr_ms"] / t["frames"]
