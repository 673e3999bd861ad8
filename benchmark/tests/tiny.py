"""Settings that shrink a cell to a size the CPU runs in seconds: the
field, the images, the samples and the iterations cut; the program runs
its kernels' plain versions there."""

import json
import time

import torch

from benchmark import harness

TINY = {"field": {"depth": 2, "width": 32, "feature_dim": 8, "skips": [1],
                  "n_freqs_xyz": 4, "n_freqs_dir": 2, "dtype": "float32"},
        "scene": {"H": 128, "W": 160, "df": 2, "focal": 150.0},
        "refine": {"opt_iter": 10},
        "render": {"n_samples": 8, "n_importance": 8},
        "train": {"n_rand": 64}}
SEED = 2 ** 31 + 11


def cell(name: str, config_file: str | None = None):
    """Cell `name` of BENCHMARK.json, with another configuration file when
    given."""
    c = harness.load_cell(name)
    if config_file is not None:
        c.config = json.loads((harness.HERE / config_file).read_text())
    return c


def run_tiny(c, seed: int = SEED, trace: bool = False) -> dict:
    """One run of cell c on the CPU at the tiny size: the runner's record
    (its `checks` hold every number compared with the reference)."""
    return harness.runner(c.traffic["kind"]).run(
        c, seed, 0.05, trace, torch.device("cpu"), time.perf_counter(), TINY)


def result_tiny(c, seed: int = SEED) -> dict:
    """The result line's object of one run of cell c at the tiny size."""
    from benchmark.run import run_cell
    return run_cell(c, seed, 0.05, False, torch.device("cpu"),
                    time.perf_counter(), TINY)
