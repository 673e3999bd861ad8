"""The harness on the CPU: every cell finds its files by the names in
BENCHMARK.json, names and units keep to their characters, each per-layer
metric is reported where the end-to-end metric it moves is, a run
without a card exits non-zero and prints nothing, and nothing a run
imports is JAX or the JAX package."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(BENCH) == KEYS


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.traffic["kind"] in ("refine", "train")
    harness.runner(cell.traffic["kind"])
    assert (harness.HERE / "limits" / f"{name}.json").exists()
    assert cell.limits, "a cell compares at least one number"
    for m in cell.end_to_end + cell.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_config_files_under_paths():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith(tuple(BENCH["paths"])) and path.exists()
        assert json.loads(path.read_text())["name"] == c["name"]


def test_names_and_units():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


def test_each_layer_metric_beside_what_it_moves():
    for name in CELLS:
        cell = harness.load_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])


def test_share_readers_never_read_zero_without_a_trace():
    run = {"kind": "refine", "setup_s": 1.0, "window_s": 2.0,
           "frame_latencies": [1.0, 1.0]}
    for m in BENCH["per_layer"]:
        assert harness.read_metric(m["name"], run) is None, m["name"]


def test_run_without_a_card_exits_nonzero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nothing_imports_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.harness, benchmark.control\n"
        "import benchmark.refine_cell, benchmark.train_cell\n"
        "import benchmark.reference.nefes, benchmark.reference.dfnet\n"
        "import benchmark.reference.mstransformer\n"
        "import benchmark.reference.refine, benchmark.tracing\n"
        "import nefes_tpu_torch.cli.refine, nefes_tpu_torch.cli.train\n"
        "import nefes_tpu_torch.refine, nefes_tpu_torch.train\n"
        "import nefes_tpu_torch.features, nefes_tpu_torch.kernels.build\n"
        "from benchmark.harness import forbidden_loaded\n"
        "print(','.join(forbidden_loaded()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nefes_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_loaded() == ["jaxlib"]
