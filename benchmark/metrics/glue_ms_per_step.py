"""Device ms a training step outside the program's field kernels (K5,
K6 +dW, dW): the ray sampling, the importance samples, the composite,
the exposure, the losses and Adam."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not t["steps"]:
        return None
    return (1e3 * t["busy_s"] - t["kernel_ms"]) / t["steps"]
