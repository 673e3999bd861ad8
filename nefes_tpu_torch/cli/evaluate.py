"""Pose-evaluation CLI; port of nefes_tpu/cli/evaluate.py (the
reference's script/eval.py).

  python -m nefes_tpu_torch.cli.evaluate --pred <poses.txt> --gt <gt.txt>
  python -m nefes_tpu_torch.cli.evaluate --paper_result <ref_root> [--scene chess]

Prints the median and mean errors and the reference's accuracy buckets
(eval.py:53-90).
"""

from __future__ import annotations

import argparse
import json

from nefes_tpu_torch.evaluation import (
    evaluate_all, evaluate_scene, load_pose_txt, paper_result_dir,
    pose_errors, summarize,
)


def print_summary(name: str, s: dict):
    print(f"== {name} ({s['n_frames']} frames) ==")
    print(f"pose Median error {s['median_t_m']:.4f}m and "
          f"{s['median_r_deg']:.4f} degrees.")
    print(f"pose Mean error {s['mean_t_m']:.4f}m and "
          f"{s['mean_r_deg']:.4f} degrees.")
    for k, v in s["accuracy"].items():
        print(f"{k}: {v:.1f}%")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred", help="predicted pose txt (N x 12)")
    p.add_argument("--gt", help="ground-truth pose txt (N x 12)")
    p.add_argument("--paper_result",
                   help="reference root; evaluates recorded paper results")
    p.add_argument("--scene", default=None)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    if args.pred and args.gt:
        s = summarize(pose_errors(load_pose_txt(args.pred),
                                  load_pose_txt(args.gt)))
        if args.json:
            print(json.dumps(s))
        else:
            print_summary(args.pred, s)
        return s

    if args.paper_result:
        if args.scene:
            for ds in ("7Scenes_colmap", "Cambridge"):
                base = paper_result_dir(args.paper_result, ds)
                if not (base / args.scene).is_dir():
                    continue
                for refined in (False, True):
                    try:
                        s = evaluate_scene(base / args.scene, args.scene,
                                           refined)
                    except FileNotFoundError:
                        continue
                    tag = "NeFeS50" if refined else "APR"
                    if args.json:
                        print(json.dumps({f"{args.scene}/{tag}": s}))
                    else:
                        print_summary(f"{args.scene} {tag}", s)
            return None
        results = evaluate_all(args.paper_result)
        if args.json:
            print(json.dumps(results))
        else:
            for k, s in results.items():
                print_summary(k, s)
        return results

    p.error("need --pred/--gt or --paper_result")


if __name__ == "__main__":
    main()
