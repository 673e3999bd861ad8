"""Process start to the first timed frame or step: imports, the kernels'
libraries (built on a checkout's first run), weights from the seed,
inputs, warm-up and capture (host clock)."""


def read(run):
    return run["setup_s"]
