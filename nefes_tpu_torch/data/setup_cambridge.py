"""Cambridge Landmarks dataset setup — the data/setup_cambridge.py
equivalent (reference :10-229); port of nefes_tpu/data/setup_cambridge.py.

Per scene: parse the NVM SfM reconstruction, rescale every image so
H=480 (focal scaled along), write 4x4 c2w pose txts + calibration txts,
z-buffer-project the SfM points into per-image scene-coordinate
initialization targets, and place the semantic masks — producing the
train|test/{rgb,poses,calibration,init,semantic} layout
data/cambridge.py loads.

Deviations from the reference (documented, not accidental):
  * init targets are saved as .npy instead of torch .dat — nothing in the
    NeFeS pipeline consumes them (they are dsac* scene-coordinate
    targets); the projection math is kept for parity.
  * pure numpy/PIL: no torch/skimage dependency.

Usage:
  python -m nefes_tpu_torch.data.setup_cambridge --root out_dir \
      [--scenes KingsCollege ...] [--source /dir/with/zips] [--no-download]
"""

from __future__ import annotations

import argparse
import math
import os
import os.path as osp
import subprocess
import zipfile

import numpy as np

SCENE_URLS = {
    "KingsCollege": "https://www.repository.cam.ac.uk/bitstream/handle/"
                    "1810/251342/KingsCollege.zip",
    "OldHospital": "https://www.repository.cam.ac.uk/bitstream/handle/"
                   "1810/251340/OldHospital.zip",
    "ShopFacade": "https://www.repository.cam.ac.uk/bitstream/handle/"
                  "1810/251336/ShopFacade.zip",
    "StMarysChurch": "https://www.repository.cam.ac.uk/bitstream/handle/"
                     "1810/251294/StMarysChurch.zip",
}
SEMANTIC_URL = ("https://www.robots.ox.ac.uk/~shuaic/NeFeS2024/"
                "Cambridge_semantic.zip")
TARGET_HEIGHT = 480      # setup_cambridge.py:22
NN_SUBSAMPLING = 8       # :23


def _quat_to_rotmat(q):
    """wxyz -> R via the axis-angle route the reference takes
    (:120-130; equivalent to the direct formula)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def parse_nvm(lines: list[str]):
    """Parse an NVM reconstruction (reference :48-77).

    Returns (cameras, pts_per_cam): cameras = list of dicts {name, focal,
    qvec (4,), center (3,)}; pts_per_cam[i] = (N_i, 3) float array of the
    3D points observed by camera i.
    """
    num_cams = int(lines[2])
    cameras = []
    for i in range(num_cams):
        e = lines[3 + i].split()
        cameras.append({
            "name": e[0],
            "focal": float(e[1]),
            "qvec": np.array(e[2:6], np.float64),
            "center": np.array(e[6:9], np.float64),
        })
    num_pts = int(lines[num_cams + 4])
    pts = [[] for _ in range(num_cams)]
    start = num_cams + 5
    for row in lines[start:start + num_pts]:
        e = row.split()
        xyz = [float(v) for v in e[0:3]]
        n_views = int(e[6])
        for v in range(n_views):
            cam = int(e[7 + v * 4])
            pts[cam].append(xyz)
    return cameras, [np.array(p, np.float64).reshape(-1, 3) for p in pts]


def camera_w2c(cam: dict) -> np.ndarray:
    """NVM camera -> 4x4 world->cam (reference :117-141: R from quat,
    t = -R @ C)."""
    R = _quat_to_rotmat(cam["qvec"])
    t = -R @ cam["center"]
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = t
    return m


def project_init_target(w2c: np.ndarray, pts3d: np.ndarray, focal: float,
                        out_h: int, out_w: int, out_scale: float):
    """z-buffered scene-coordinate target (reference :188-218).
    Returns (3, out_h, out_w) coords + zbuffer."""
    target = np.zeros((3, out_h, out_w), np.float32)
    zbuf = np.zeros((out_h, out_w), np.float32)
    if len(pts3d) == 0:
        return target
    hom = np.concatenate([pts3d, np.ones((len(pts3d), 1))], axis=1)
    cam = (w2c @ hom.T)[:3]                     # (3, N)
    img = cam[:2] * focal / cam[2] * out_scale
    xs = np.clip((img[0] + out_w / 2).astype(int), 0, out_w - 1)
    ys = np.clip((img[1] + out_h / 2).astype(int), 0, out_h - 1)
    for i in range(len(pts3d)):
        z = cam[2, i]
        if z > 1000:                            # outlier depth filter
            continue
        y, x = ys[i], xs[i]
        if zbuf[y, x] == 0 or zbuf[y, x] > z:
            zbuf[y, x] = z
            target[:, y, x] = pts3d[i]
    return target


def convert_scene(scene_dir: str, out_dir: str,
                  target_height: int = TARGET_HEIGHT,
                  write_init: bool = True) -> int:
    """Convert one extracted Cambridge scene (reconstruction.nvm +
    dataset_{train,test}.txt + images) into the loader layout. Returns the
    number of frames written."""
    from PIL import Image as PILImage

    lines = open(osp.join(scene_dir, "reconstruction.nvm")).read() \
        .splitlines()
    cameras, pts_per_cam = parse_nvm(lines)
    written = 0

    for mode in ("train", "test"):
        for sub in ("rgb", "poses", "calibration", "init"):
            os.makedirs(osp.join(out_dir, mode, sub), exist_ok=True)
        listing = open(osp.join(scene_dir,
                                f"dataset_{mode}.txt")).read().splitlines()
        names = [l.split()[0] for l in listing[3:] if l.strip()]
        name_set = set(names)

        for ci, cam in enumerate(cameras):
            img_name = cam["name"][:-3] + "png"
            if img_name not in name_set:
                continue
            w2c = camera_w2c(cam)
            if np.abs(w2c[:3, 3]).max() > 10000:   # outlier filter (:136)
                continue

            img = PILImage.open(osp.join(scene_dir, img_name))
            iw, ih = img.size
            aspect = ih / iw
            if aspect > 1:     # portrait (:155-162)
                img_w = target_height
                img_h = int(math.ceil(target_height * aspect))
            else:
                img_w = int(math.ceil(target_height / aspect))
                img_h = target_height
            img_scale = img_w / iw
            flat = img_name.replace("/", "_")
            img.resize((img_w, img_h)).save(
                osp.join(out_dir, mode, "rgb", flat))

            with open(osp.join(out_dir, mode, "calibration",
                               flat[:-3] + "txt"), "w") as f:
                f.write(str(cam["focal"] * img_scale))

            c2w = np.linalg.inv(w2c)
            np.savetxt(osp.join(out_dir, mode, "poses",
                                flat[:-3] + "txt"), c2w)

            if write_init:
                out_w = int(math.ceil(img_w / NN_SUBSAMPLING))
                out_h = int(math.ceil(img_h / NN_SUBSAMPLING))
                target = project_init_target(
                    w2c, pts_per_cam[ci], cam["focal"], out_h, out_w,
                    out_w / iw)
                np.save(osp.join(out_dir, mode, "init", flat[:-4] + ".npy"),
                        target)
            written += 1
    return written


def setup_cambridge(root: str, scenes=tuple(SCENE_URLS),
                    source: str | None = None, download: bool = True,
                    world_setup_dir: str | None = None,
                    semantic_zip: str | None = None) -> None:
    out_base = osp.join(root, "Cambridge")
    os.makedirs(out_base, exist_ok=True)
    for scene in scenes:
        zip_path = osp.join(source, f"{scene}.zip") if source else None
        if zip_path is None or not osp.exists(zip_path):
            if not download:
                raise FileNotFoundError(f"{scene}.zip missing and "
                                        "downloads disabled")
            zip_path = osp.join(root, f"{scene}.zip")
            subprocess.run(["wget", "-q", "-O", zip_path,
                            SCENE_URLS[scene]], check=True)
        extract = osp.join(root, f"_extract_{scene}")
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(extract)
        scene_src = osp.join(extract, scene)
        out_dir = osp.join(out_base, scene)
        n = convert_scene(scene_src, out_dir)
        print(f"{scene}: {n} frames converted")
        if world_setup_dir:
            for name in os.listdir(osp.join(world_setup_dir, scene)):
                import shutil
                shutil.copy(osp.join(world_setup_dir, scene, name), out_dir)

    if semantic_zip is None and download:
        semantic_zip = osp.join(root, "Cambridge_semantic.zip")
        subprocess.run(["wget", "-q", "-O", semantic_zip, SEMANTIC_URL],
                       check=True)
    if semantic_zip and osp.exists(semantic_zip):
        with zipfile.ZipFile(semantic_zip) as z:
            z.extractall(root)
        import shutil
        for scene in scenes:
            for mode in ("train", "test"):
                src = osp.join(root, "Cambridge_semantic",
                               f"{scene}_semantic_{mode}")
                if osp.isdir(src):
                    shutil.copytree(src, osp.join(out_base, scene, mode,
                                                  "semantic"),
                                    dirs_exist_ok=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=".")
    p.add_argument("--scenes", nargs="+", default=list(SCENE_URLS))
    p.add_argument("--source", default=None)
    p.add_argument("--no-download", action="store_true")
    p.add_argument("--world-setup", default=None,
                   help="reference data/Cambridge_world_setup dir")
    p.add_argument("--semantic-zip", default=None)
    a = p.parse_args(argv)
    setup_cambridge(a.root, a.scenes, a.source, not a.no_download,
                    a.world_setup, a.semantic_zip)


if __name__ == "__main__":
    main()
