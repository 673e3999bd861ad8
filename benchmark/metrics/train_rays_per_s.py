"""Rays trained a second: every ray of the steps in the window over the
window, which ends at the last step's synchronise (host clock)."""


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return run["steps"] * run["rays_per_step"] / run["window_s"]
