"""COLMAP sparse-model IO: cameras / images / points3D, text and binary;
port of nefes_tpu/utils/colmap.py (numpy and struct, as there).

Role of reference script/utils/colmap.py:103-455 (itself the standard
COLMAP scripts): read/write the .txt and .bin sparse reconstruction
formats, plus the qvec/rotmat helpers the pose pipelines use. Implemented
from the public format spec with numpy structs — no torch.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, n_params)  (COLMAP camera models)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NPARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray        # (4,) wxyz, world->cam
    tvec: np.ndarray        # (3,)
    camera_id: int
    name: str
    xys: np.ndarray         # (N, 2)
    point3D_ids: np.ndarray  # (N,) int64, -1 = no point

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (colmap.py convention)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """rotation matrix -> wxyz quaternion (eigen-decomposition of K, the
    numerically-stable method the COLMAP scripts use)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ---------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------

def read_cameras_text(path: str) -> dict[int, Camera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        out[int(e[0])] = Camera(int(e[0]), e[1], int(e[2]), int(e[3]),
                                np.array(e[4:], np.float64))
    return out


def write_cameras_text(cameras: dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cameras.values():
            p = " ".join(repr(float(v)) for v in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {p}\n")


def read_images_text(path: str) -> dict[int, Image]:
    out = {}
    lines = [l.strip() for l in open(path)
             if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        pts = lines[i + 1].split()
        xys = np.array(pts, np.float64).reshape(-1, 3)[:, :2] \
            if pts else np.zeros((0, 2))
        ids = np.array(pts[2::3], np.int64) if pts else np.zeros(0, np.int64)
        out[int(e[0])] = Image(
            int(e[0]), np.array(e[1:5], np.float64),
            np.array(e[5:8], np.float64), int(e[8]), e[9], xys, ids)
    return out


def write_images_text(images: dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{float(x)!r} {float(y)!r} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


def read_points3D_text(path: str) -> dict[int, Point3D]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        track = np.array(e[8:], np.int64).reshape(-1, 2)
        out[int(e[0])] = Point3D(
            int(e[0]), np.array(e[1:4], np.float64),
            np.array(e[4:7], np.int64), float(e[7]),
            track[:, 0], track[:, 1])
    return out


def write_points3D_text(points: dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j
                             in zip(p.image_ids, p.point2D_idxs))
            f.write(f"{p.id} {xyz} {rgb} {float(p.error)!r} {track}\n")


# ---------------------------------------------------------------------
# binary format
# ---------------------------------------------------------------------

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            cid, mid, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[mid]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cid] = Camera(cid, name, w, h, params)
    return out


def write_cameras_binary(cameras: dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def read_images_binary(path: str) -> dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read(f, "<Q")[0]
            if n_pts:
                raw = _read(f, "<" + "ddq" * n_pts)  # (x, y, point3D_id)*
                data = np.array(raw, np.float64).reshape(-1, 3)
                xys = data[:, :2]
                ids = np.array(raw[2::3], np.int64)
            else:
                xys = np.zeros((0, 2))
                ids = np.zeros(0, np.int64)
            out[iid] = Image(iid, qvec, tvec, cam_id, name.decode(),
                             xys, ids)
    return out


def write_images_binary(images: dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def read_points3D_binary(path: str) -> dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            err = _read(f, "<d")[0]
            tl = _read(f, "<Q")[0]
            track = np.array(_read(f, f"<{2 * tl}i")).reshape(-1, 2) \
                if tl else np.zeros((0, 2), np.int32)
            out[pid] = Point3D(pid, xyz, rgb, err,
                               track[:, 0].astype(np.int64),
                               track[:, 1].astype(np.int64))
    return out


def write_points3D_binary(points: dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *(int(v) for v in p.rgb)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))


# ---------------------------------------------------------------------
# model-level helpers
# ---------------------------------------------------------------------

def read_model(path: str, ext: str | None = None):
    """Read (cameras, images, points3D) from a sparse model dir. ext
    auto-detected from the files present when None."""
    if ext is None:
        ext = ".bin" if os.path.exists(
            os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3D_text(os.path.join(path, "points3D.txt")))
    return (read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3D_binary(os.path.join(path, "points3D.bin")))


def write_model(cameras, images, points3D, path: str,
                ext: str = ".bin") -> None:
    os.makedirs(path, exist_ok=True)
    if ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3D_text(points3D, os.path.join(path, "points3D.txt"))
    else:
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3D_binary(points3D, os.path.join(path, "points3D.bin"))
