"""Device ms a frame inside the refinement outside the program's CUDA
kernels and the APR: the embedding, the pose algebra, the render's
driver, the exposure, FusionNet, the resize, the loss, the verification
metrics and the optimizer."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "refine" or not t or t["glue_ms"] <= 0:
        return None
    return t["glue_ms"] / t["frames"]
