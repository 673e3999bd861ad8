"""Run a cell several times, each run a process of its own as a check runs
it, and report each metric's spread: the distance between the first and
the third quartile (statistics.quantiles, n=4) as a share of the median,
per set of runs. The numbers each run compared with the reference are
kept beside its metrics.

  python3 benchmark/spread.py --workload <cell> --seeds 1 2 3 4 5 6 \
      --sets 2 --seconds 30 [--trace 0] [--out FILE]

Every set runs the same seeds, in order.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True)
    row = {"seed": seed, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0,
           "readings": [ln for ln in p.stderr.splitlines()
                        if ln.startswith(("reading ", "check "))]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    else:
        row["stderr_tail"] = p.stderr[-3000:]
    return row


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sets = []
    for s in range(args.sets):
        rows = []
        for seed in args.seeds:
            row = one_run(args.workload, seed, args.seconds, args.trace)
            print(json.dumps(row), flush=True)
            rows.append(row)
        sets.append(rows)
    summary = []
    for s, rows in enumerate(sets):
        ok = [r["result"] for r in rows if "result" in r]
        metrics = {}
        for name in sorted({m for r in ok for m in r["metrics"]}):
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            metrics[name] = {"median": statistics.median(vals),
                             "spread": spread(vals), "values": vals}
        summary.append({"set": s, "runs": len(rows), "ok": len(ok),
                        "correct": sum(bool(r["correct"]) for r in ok),
                        "metrics": metrics})
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"sets": sets,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
