"""The port's remaining host-side modules against the JAX package's, on
the CPU, the same inputs through both:

* utils/colmap.py: text and binary models written by either package read
  back equal by both, across formats; qvec <-> rotmat equal;
* utils/kalman.py: kalman_1d / kalman_3d to 1e-12;
* data/augment.py: color_jitter equal to the bit from the same numpy
  seed (the contrast mean summed in numpy's order);
* data/multiframe.py: indices, batches and relative poses equal;
* data/llff_blender.py on tests/test_llff_blender.py's fixtures: images
  to 1e-6 (the bilinear resize's summation order), poses, bounds,
  splits and histograms equal;
* data/setup_7scenes.py and data/setup_cambridge.py through their CLIs
  on synthetic archives (tests/test_setup_and_colmap.py's), offline:
  the trees and every file's bytes equal to what the JAX scripts write
  from the same archive; a missing archive without downloads raises.
"""

import os
import os.path as osp
import zipfile

import numpy as np
import pytest
import torch

from nefes_tpu.data import augment as jaug
from nefes_tpu.data import llff_blender as jllff
from nefes_tpu.data import multiframe as jmf
from nefes_tpu.data import setup_7scenes as j7
from nefes_tpu.data import setup_cambridge as jcam
from nefes_tpu.utils import colmap as jcol
from nefes_tpu.utils import kalman as jkal
from nefes_tpu_torch.data import augment as taug
from nefes_tpu_torch.data import llff_blender as tllff
from nefes_tpu_torch.data import multiframe as tmf
from nefes_tpu_torch.data import setup_7scenes as t7
from nefes_tpu_torch.data import setup_cambridge as tcam
from nefes_tpu_torch.utils import colmap as tcol
from nefes_tpu_torch.utils import kalman as tkal
from tests.test_llff_blender import _write_blender, _write_llff
from tests.test_setup_and_colmap import (
    _make_7scenes_zip, _make_nvm_scene, _tiny_model,
)


# --- COLMAP ---

def _same_model(a, b):
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            for field in vars(x[k]):
                u, v = getattr(x[k], field), getattr(y[k], field)
                if isinstance(u, np.ndarray):
                    assert u.dtype == v.dtype, field
                    np.testing.assert_array_equal(u, v, err_msg=field)
                else:
                    assert u == v, field


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_colmap_io_matches_jax(tmp_path, ext):
    model = _tiny_model()                          # the JAX dataclasses
    tmodel = tuple({k: getattr(tcol, type(v).__name__)(**vars(v))
                    for k, v in part.items()} for part in model)
    jcol.write_model(*model, str(tmp_path / "j"), ext=ext)
    tcol.write_model(*tmodel, str(tmp_path / "t"), ext=ext)
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    for d in ("j", "t"):
        _same_model(tcol.read_model(str(tmp_path / d)),
                    jcol.read_model(str(tmp_path / d)))
    # across formats: the port's binary copy of a text model
    other = ".bin" if ext == ".txt" else ".txt"
    tcol.write_model(*tcol.read_model(str(tmp_path / "j")),
                     str(tmp_path / "x"), ext=other)
    _same_model(jcol.read_model(str(tmp_path / "x")),
                jcol.read_model(str(tmp_path / "j")))


def test_qvec_rotmat_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = jcol.qvec2rotmat(q)
        np.testing.assert_array_equal(tcol.qvec2rotmat(q), R)
        np.testing.assert_array_equal(tcol.rotmat2qvec(R),
                                      jcol.rotmat2qvec(R))


# --- Kalman, augment, multiframe ---

def test_kalman_matches_jax():
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    for damping in (0.5, 1.0, 4.0):
        np.testing.assert_allclose(tkal.kalman_3d(walk, damping),
                                   jkal.kalman_3d(walk, damping), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tkal.kalman_1d(walk[:, 0], damping),
                                   jkal.kalman_1d(walk[:, 0], damping),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 32, 3), (2, 60, 80, 3),
                                   (1, 120, 160, 3)])
def test_color_jitter_matches_jax(shape):
    for seed in range(4):
        img = np.random.default_rng(seed).uniform(size=shape).astype(
            np.float32)
        want = jaug.color_jitter(img, np.random.default_rng(seed + 9))
        got = taug.color_jitter(torch.from_numpy(img),
                                np.random.default_rng(seed + 9))
        np.testing.assert_array_equal(got.numpy(), want)
    # an op switched off leaves the draws of the others as JAX's
    kw = dict(brightness=None)
    np.testing.assert_array_equal(
        taug.color_jitter(torch.from_numpy(img), np.random.default_rng(1),
                          **kw).numpy(),
        jaug.color_jitter(img, np.random.default_rng(1), **kw))


def test_multiframe_matches_jax():
    from nefes_tpu_torch.data.synthetic import make_synthetic_scene
    scene = make_synthetic_scene(n_views=6, H=8, W=8, device="cpu")
    for steps in (2, 3):
        np.testing.assert_array_equal(tmf.multiframe_indices(7, steps),
                                      jmf.multiframe_indices(7, steps))
        for index in (0, 3, np.array([0, 4, 5])):
            got = tmf.multiframe_batch(scene, index, steps=steps)
            want = jmf.multiframe_batch(scene, index, steps=steps)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        tmf.relative_pose(scene.poses[:3], scene.poses[3:]),
        jmf.relative_pose(scene.poses[:3], scene.poses[3:]))


# --- LLFF / Blender ---

def _same(got, want, msg):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{msg}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _same(got[k], want[k], f"{msg}.{k}")
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=msg)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        assert got == want, msg


def test_llff_blender_match_jax(tmp_path):
    blender, llff = str(tmp_path / "blender"), str(tmp_path / "llff")
    os.makedirs(blender)
    _write_blender(blender)
    _write_llff(llff)
    for half_res in (False, True):
        for white in (False, True):
            _same(tllff.load_blender_data(blender, half_res=half_res,
                                          white_bkgd=white),
                  jllff.load_blender_data(blender, half_res=half_res,
                                          white_bkgd=white), "blender")
    for factor in (None, 2):
        _same(tllff.load_llff_data(llff, factor=factor),
              jllff.load_llff_data(llff, factor=factor), "llff")
    for typ, root, kw in (("blender", blender, dict(white_bkgd=True)),
                          ("llff", llff, dict(factor=2, llffhold=3)),
                          ("llff", llff, dict(factor=2, llffhold=0,
                                              no_ndc=True))):
        _same(tllff.load_dataset(typ, root, **kw),
              jllff.load_dataset(typ, root, **kw), typ)
    with pytest.raises(NotImplementedError):
        tllff.load_llff_data(llff, spherify=True)
    with pytest.raises(ValueError):
        tllff.load_dataset("nerf", llff)


# --- the dataset set-up scripts, offline ---

def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dp, _, fns in os.walk(root):
        for f in fns:
            p = osp.join(dp, f)
            with open(p, "rb") as fh:
                out[osp.relpath(p, root)] = fh.read()
    return out


def test_setup_7scenes_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    zpath, colmap_dir, _ = _make_7scenes_zip(str(src))
    for name, mod in (("jax", j7), ("port", t7)):
        mod.main(["--root", str(tmp_path / name), "--scenes", "chess",
                  "--source", osp.dirname(zpath), "--no-download",
                  "--colmap-poses", colmap_dir])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert any(k.endswith("color.png") for k in got)
    assert any(k.endswith("chess_train.txt") for k in got)
    with pytest.raises(FileNotFoundError):
        t7.main(["--root", str(tmp_path / "none"), "--scenes", "fire",
                 "--source", osp.dirname(zpath), "--no-download"])


def test_setup_cambridge_matches_jax(tmp_path):
    scene_dir = tmp_path / "build" / "KingsCollege"
    scene_dir.mkdir(parents=True)
    _make_nvm_scene(str(scene_dir))
    src = tmp_path / "src"
    src.mkdir()
    with zipfile.ZipFile(src / "KingsCollege.zip", "w") as z:
        for dp, _, fns in os.walk(scene_dir):
            for f in fns:
                p = osp.join(dp, f)
                z.write(p, osp.relpath(p, tmp_path / "build"))
    ws = tmp_path / "ws" / "KingsCollege"
    ws.mkdir(parents=True)
    (ws / "world_setup.json").write_text('{"near": 0.1, "far": 10.0}')
    sem = tmp_path / "sem.zip"
    with zipfile.ZipFile(sem, "w") as z:
        for mode in ("train", "test"):
            z.writestr(f"Cambridge_semantic/KingsCollege_semantic_{mode}/"
                       "seq1_frame00000.png", b"mask-" + mode.encode())
    for name, mod in (("jax", jcam), ("port", tcam)):
        mod.main(["--root", str(tmp_path / name), "--scenes", "KingsCollege",
                  "--source", str(src), "--no-download", "--world-setup",
                  str(tmp_path / "ws"), "--semantic-zip", str(sem)])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    kinds = {k.split(os.sep)[3] for k in got
             if k.startswith(osp.join("Cambridge", "KingsCollege", "train"))}
    assert kinds == {"rgb", "poses", "calibration", "init", "semantic"}
    assert osp.join("Cambridge", "KingsCollege", "world_setup.json") in got
    with pytest.raises(FileNotFoundError):
        tcam.main(["--root", str(tmp_path / "none"), "--scenes",
                   "ShopFacade", "--source", str(src), "--no-download"])
