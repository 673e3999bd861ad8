"""The controls of the comparison that decides `correct`: the reference
put in the program's place, computed in the precision below the one the
configuration states (the field in fp8, the APR and the feature
extractor in bf16), and for the training cell the planted fault that
leaves half of each image's rays out of the loss. Each prints the
numbers a run compares, judged against the float32 reference, so that
they can be set beside the program's own readings. The benchmark's runs
do not run this.

  python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
      [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def refine_control(cell, seed: int, device, overrides=None) -> dict:
    """The reference computed in the lower precision, put in the program's
    place on the cell's checked frames, judged as a run judges them."""
    import torch

    from benchmark.harness import Checks
    from benchmark.refine_cell import (
        _geometry, _settings, frame_inputs, judge_frame, reference_frame,
        reference_models,
    )
    config, traffic = _settings(cell, overrides or {})
    geo = _geometry(config)
    pool, hists = frame_inputs(config, seed, device)
    ws_vec = torch.tensor(geo["ws_vec"], dtype=torch.float32, device=device)
    mode = traffic["mode"]
    frames = range(traffic["checked_frames"])
    lows = {}
    low_models = reference_models(config, seed, device, True)
    for i in frames:
        lows[i], _ = reference_frame(config, mode, geo, *low_models, pool,
                                     hists, ws_vec, i)
    del low_models
    checks = Checks({})
    models_ = reference_models(config, seed, device, False)
    for i in frames:
        hi, loss_at = reference_frame(config, mode, geo, *models_, pool,
                                      hists, ws_vec, i)
        lo = lows[i]
        out = {"losses": lo["losses"], "initial_pose": lo["initial"].cpu(),
               "refined_pose": lo["refined"].cpu()}
        final = lo["verified"] if mode == 2 else lo["refined"]
        out["verified_pose"] = out["host_pose"] = final.cpu()
        if mode == 2:
            out.update(init_psnr=lo["psnrs0"], end_psnr=lo["psnrs-1"],
                       init_ssim=lo["ssims0"], end_ssim=lo["ssims-1"])
        judge_frame(checks, out, hi, mode, f"frame {i}", loss_at)
    return {"control": checks.numbers, "where": checks.where}


def train_control(cell, seed: int, device, overrides=None) -> dict:
    from benchmark.harness import Checks
    from benchmark.refine_cell import _settings
    from benchmark.train_cell import judge, reference_steps
    config, traffic = _settings(cell, overrides or {})
    full = reference_steps(config, traffic, seed, device)
    out = {}
    for name, kw in (("control", {"low": True}),
                     ("half_batch", {"keep_rows": 0.5})):
        checks = Checks({})
        judge(checks, reference_steps(config, traffic, seed, device, **kw),
              full)
        out[name] = checks.numbers
        out[name + "_where"] = checks.where
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    fn = train_control if cell.traffic["kind"] == "train" else refine_control
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = {"seed": seed, **fn(cell, seed, torch.device("cuda")),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
