"""The reference's recorded paper results as a golden file; port of
nefes_tpu/evaluation/golden.py. Recomputes the paper table's medians from
the pose txts in paper_result/ alone (the reference's eval.sh)."""

from __future__ import annotations

from pathlib import Path

from nefes_tpu_torch.evaluation.metrics import (
    load_pose_txt, pose_errors, summarize,
)

SEVEN_SCENES = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
                "stairs")
CAMBRIDGE_SCENES = ("KingsCollege", "OldHospital", "ShopFacade",
                    "StMarysChurch")


def paper_result_dir(reference_root: str | Path, dataset: str) -> Path:
    root = Path(reference_root) / "paper_result"
    if dataset == "7Scenes_colmap":
        return root / "DFNet_NeFeS50_7Scenes_colmap"
    if dataset == "Cambridge":
        return root / "DFNet_NeFeS50_Cambridge"
    raise ValueError(f"unknown dataset {dataset!r}")


def evaluate_scene(scene_dir: str | Path, scene: str,
                   refined: bool = True) -> dict:
    """The error summary of one scene from its recorded txts: the
    DFNet + NeFeS50 poses (refined) or the initial DFNet ones."""
    scene_dir = Path(scene_dir)
    suffix = "_NeFeS50_APR_pose_results.txt" if refined else "_results.txt"
    pred = load_pose_txt(scene_dir / f"DFNet_{scene}{suffix}")
    gt = load_pose_txt(scene_dir / f"{scene}_test_gt.txt")
    if pred.shape != gt.shape:
        raise ValueError(f"{scene}: {pred.shape} poses against {gt.shape}")
    return summarize(pose_errors(pred, gt))


def evaluate_all(reference_root: str | Path) -> dict:
    """Every scene of both datasets, refined and not."""
    out = {}
    for dataset, scenes in (("7Scenes_colmap", SEVEN_SCENES),
                            ("Cambridge", CAMBRIDGE_SCENES)):
        base = paper_result_dir(reference_root, dataset)
        for scene in scenes:
            for refined in (False, True):
                key = f"{dataset}/{scene}/" + ("NeFeS50" if refined
                                                else "APR")
                out[key] = evaluate_scene(base / scene, scene, refined)
    return out
