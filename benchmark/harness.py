"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, the per-layer and end-to-end metric readers, the limits
and the comparison that decides `correct`, the result's last line, and
the check that no JAX module was loaded.

A cell names a configuration (benchmark/configs/<config>.json) and a
traffic mix (benchmark/traffic/<traffic>.json, whose "kind" names the
runner benchmark/<kind>_cell.py); its limits are
benchmark/limits/<cell>.json; each metric is read by
benchmark/metrics/<metric>.py, whose read(run) returns the value or None
when the run has nothing to read it from."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nefes_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list            # metric entries of BENCHMARK.json
    per_layer: list
    limits: dict                # number -> limit


def _entries(bench: dict, key: str, cell: str, moves_ok=None) -> list:
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif moves_ok is None or m.get("moves") in moves_ok:
            out.append(m)
    return out


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic, metrics and limits; raises KeyError for an unknown cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = _entries(bench, "end_to_end", name)
    names = {m["name"] for m in e2e}
    per_layer = _entries(bench, "per_layer", name, moves_ok=names)
    limits_file = HERE / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer,
                limits)


def runner(kind: str):
    """The module that runs traffic of this kind."""
    return importlib.import_module(f"benchmark.{kind}_cell")


def read_metric(name: str, run: dict):
    """benchmark/metrics/<name>.py's read(run): a number or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


@dataclass
class Checks:
    """The numbers compared with the reference, each beside its limit (a
    number with no limit is a reading: printed, not judged)."""
    limits: dict
    numbers: dict = field(default_factory=dict)
    where: dict = field(default_factory=dict)

    def add(self, name: str, value: float, where: str = "") -> None:
        """Keep the largest value seen under a name (the worst frame or
        leaf, named by `where`); NaN stays NaN."""
        old = self.numbers.get(name)
        if old is None or math.isnan(value) or (
                not math.isnan(old) and value > old):
            self.numbers[name] = float(value)
            self.where[name] = where

    @property
    def correct(self) -> bool:
        for name, limit in self.limits.items():
            v = self.numbers.get(name)
            if v is None or math.isnan(v) or v > limit:
                return False
        return True

    def report(self) -> dict:
        """{name: {"value", "limit"}} of the compared numbers."""
        return {k: {"value": self.numbers.get(k), "limit": lim}
                for k, lim in self.limits.items()}

    def lines(self) -> list[str]:
        def at(k):
            return f" at {self.where[k]}" if self.where.get(k) else ""
        out = [f"reading {k} = {v!r}{at(k)}"
               for k, v in sorted(self.numbers.items())
               if k not in self.limits]
        out += [f"check {k} = {self.numbers.get(k)!r} limit {lim!r}{at(k)}"
                for k, lim in self.limits.items()]
        return out


def forbidden_loaded() -> list[str]:
    """Top-level names of sys.modules that are JAX or the JAX package,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def metrics_block(entries: list, run: dict) -> dict:
    out = {}
    for m in entries:
        v = read_metric(m["name"], run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
