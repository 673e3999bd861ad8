"""Each cell run once on the card for a few seconds through the
benchmark's command, correct and with its metrics; skips without a
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 3), "--seconds", "3",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], p.stderr[-4000:]
    cell = harness.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["device"]["platform"] == "gpu"
