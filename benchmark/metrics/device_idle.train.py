"""The share of the traced window in which no operation ran on the
device (1 - the union of the device ops' spans over the window), in %."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
