"""Run one cell of the benchmark once and print its result as the last
line of standard output.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

A run makes its weights and inputs on the card from --seed, warms up
every shape the cell's traffic uses (set-up), measures for --seconds
with tracing off, and, with --trace 1, then traces a few frames or steps
with torch.profiler for the per-layer metrics. Once the window has
closed and the program's state is freed, it checks a sample of what the
timed path produced against the plain float32 reference
(benchmark/reference/) and prints each number compared beside its limit.
It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def _environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library loads JAX by itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), T0)
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark: JAX modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0,
             overrides: dict | None = None) -> dict:
    """Run `cell` once on `device` and return the result line's object.
    overrides: runner settings that shrink the cell (the CPU tests)."""
    import torch

    from benchmark import harness
    run = harness.runner(cell.traffic["kind"]).run(
        cell, seed, seconds, trace, device, t0, overrides or {})
    checks = run["checks"]
    for part, at in run["setup_parts"].items():
        print(f"setup: {part} done at {at:.3f} s", file=sys.stderr)
    for line in checks.lines():
        print(line, file=sys.stderr, flush=True)
    entries = cell.per_layer if trace else cell.end_to_end
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
    out = {"correct": checks.correct, "attempted": run["attempted"],
           "failed": run["failed"],
           "metrics": harness.metrics_block(entries, run), "device": dev}
    if trace:
        out["breakdown"] = run["trace"]["breakdown"]
    out["checks"] = checks.report()
    return out


if __name__ == "__main__":
    sys.exit(main())
