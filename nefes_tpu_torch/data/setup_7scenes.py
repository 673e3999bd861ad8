"""7-Scenes dataset setup — the data/setup_7scenes.py equivalent; port
of nefes_tpu/data/setup_7scenes.py.

Downloads (or consumes pre-fetched) MS 7-Scenes zips, unpacks the per-
sequence inner zips, and copies the Brachmann21 COLMAP pseudo-GT pose
tables next to the sequences — producing exactly the layout
data/seven_scenes.py loads:

  <root>/deepslam_data/7Scenes/<scene>/TrainSplit.txt TestSplit.txt
  <root>/deepslam_data/7Scenes/<scene>/seq-NN/frame-XXXXXX.{color.png,
                                                           pose.txt,...}
  <root>/deepslam_data/7Scenes/<scene>/<scene>_{train,test}.txt

Usage:
  python -m nefes_tpu_torch.data.setup_7scenes --root data_dir \
      [--scenes chess fire ...] [--source /dir/with/zips] [--no-download]

Offline environments: pass --source pointing at pre-downloaded
<scene>.zip files; --no-download fails fast instead of calling wget.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import subprocess
import zipfile

SCENES = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
          "stairs")
URL = ("http://download.microsoft.com/download/2/8/5/"
       "28564B23-0828-408F-8631-23B1EFF1DAC8/{scene}.zip")


def unpack_scene_zip(zip_path: str, dest_dir: str) -> str:
    """Extract <scene>.zip (which contains per-sequence seq-NN.zip files +
    split txts) and the inner sequence zips (setup_7scenes.py:24-35)."""
    scene = osp.splitext(osp.basename(zip_path))[0]
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(dest_dir)
    scene_dir = osp.join(dest_dir, scene)
    for name in sorted(os.listdir(scene_dir)):
        if name.endswith(".zip"):
            inner = osp.join(scene_dir, name)
            with zipfile.ZipFile(inner) as z:
                z.extractall(scene_dir)
            os.remove(inner)
    return scene_dir


def copy_colmap_poses(scene_dir: str, colmap_poses_dir: str) -> None:
    """Copy <scene>_{train,test}.txt pseudo-GT tables into the scene dir
    (setup_7scenes.py:37-38). The tables ship with the reference repo at
    data/7Scenes_colmap_poses/<scene>/."""
    scene = osp.basename(scene_dir.rstrip("/"))
    src = osp.join(colmap_poses_dir, scene)
    for name in os.listdir(src):
        if name.endswith(".txt"):
            shutil.copy(osp.join(src, name), scene_dir)


def setup_7scenes(root: str, scenes=SCENES, source: str | None = None,
                  download: bool = True,
                  colmap_poses_dir: str | None = None) -> list[str]:
    """Returns the list of prepared scene dirs."""
    dest = osp.join(root, "deepslam_data", "7Scenes")
    os.makedirs(dest, exist_ok=True)
    done = []
    for scene in scenes:
        zip_path = osp.join(source, f"{scene}.zip") if source else None
        if zip_path is None or not osp.exists(zip_path):
            if not download:
                raise FileNotFoundError(
                    f"{scene}.zip not found in --source and downloads "
                    "disabled")
            zip_path = osp.join(dest, f"{scene}.zip")
            subprocess.run(["wget", "-q", "-O", zip_path,
                            URL.format(scene=scene)], check=True)
        scene_dir = unpack_scene_zip(zip_path, dest)
        if colmap_poses_dir:
            copy_colmap_poses(scene_dir, colmap_poses_dir)
        done.append(scene_dir)
        print(f"prepared {scene_dir}")
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=".")
    p.add_argument("--scenes", nargs="+", default=list(SCENES))
    p.add_argument("--source", default=None,
                   help="dir with pre-downloaded <scene>.zip files")
    p.add_argument("--no-download", action="store_true")
    p.add_argument("--colmap-poses", default=None,
                   help="dir with <scene>/<scene>_{train,test}.txt tables "
                        "(reference data/7Scenes_colmap_poses)")
    a = p.parse_args(argv)
    setup_7scenes(a.root, a.scenes, a.source, not a.no_download,
                  a.colmap_poses)


if __name__ == "__main__":
    main()
