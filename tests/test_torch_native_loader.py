"""The port's native image decoder (nefes_tpu_torch/native: its copy of
loader.cpp, built with g++ at first use) and the 7-Scenes loaders' route
through it, as tests/test_native_loader.py holds the JAX package's:

1. against Pillow at full size: PNG bit for bit, JPEG within 0.05 (two
   libjpeg builds' IDCTs differ);
2. its box downsample against cv2.INTER_AREA at an integer ratio, 2e-6;
3. a missing file raises "failed on 1/1";
4. the 7-Scenes loader with NEFES_NATIVE_LOADER=0 (Pillow + OpenCV)
   against 1 (the decoder, which it calls) on the fixture scene, 2e-6;
5. against the JAX package's decoder on the same files, bit for bit (the
   same source and compiler);
6. a library that does not build: one line, available() False, and the
   loader reads through Pillow + OpenCV.

Skipped if the library does not build here (the fallback test runs
anyway).
"""

import os.path as osp

import numpy as np
import pytest

from nefes_tpu_torch import native

needs_lib = pytest.mark.skipif(not native.available(),
                               reason="native loader did not build")


def _write_images(tmp, n=6, hw=(64, 96)):
    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        arr = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
        ext = "png" if i % 2 == 0 else "jpg"
        p = osp.join(tmp, f"im{i:03d}.{ext}")
        Image.fromarray(arr).save(p, quality=95)
        paths.append(p)
    return paths


@needs_lib
def test_native_matches_pil_at_full_size(tmp_path):
    from PIL import Image
    paths = _write_images(str(tmp_path))
    out = native.load_images_native(paths, 64, 96)
    assert out.shape == (6, 64, 96, 3) and out.dtype == np.float32
    for i, p in enumerate(paths):
        want = np.asarray(Image.open(p), np.float32)[..., :3] / 255.0
        tol = 0.0 if p.endswith("png") else 0.05
        assert np.abs(out[i] - want).max() <= tol + 1e-6, p


@needs_lib
def test_native_box_downsample_matches_cv2_inter_area(tmp_path):
    import cv2
    from PIL import Image
    paths = [p for p in _write_images(str(tmp_path)) if p.endswith("png")]
    out = native.load_images_native(paths, 32, 48)     # ratio 2 x 2
    for i, p in enumerate(paths):
        img = np.asarray(Image.open(p), np.float32)[..., :3] / 255.0
        want = cv2.resize(img, (48, 32), interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(out[i], want, atol=2e-6)


@needs_lib
def test_native_failure_reporting(tmp_path):
    with pytest.raises(RuntimeError, match="failed on 1/1"):
        native.load_images_native([str(tmp_path / "missing.png")], 8, 8)


@needs_lib
def test_seven_scenes_route(tmp_path, monkeypatch):
    """NEFES_NATIVE_LOADER=0 reads through Pillow + OpenCV; unset or 1,
    through the decoder at (H, W) whatever df is; the same images."""
    from nefes_tpu_torch.data import load_7scenes_colmap, load_7scenes_dslam
    from tests.fixture_datasets import make_7scenes_fixture
    paths = make_7scenes_fixture(str(tmp_path))
    root = osp.dirname(paths["datadir"])
    calls = []
    real = native.load_images_native

    def counted(p, H, W, n_threads=0):
        calls.append((len(p), H, W))
        return real(p, H, W, n_threads)
    monkeypatch.setattr(native, "load_images_native", counted)
    for load in (load_7scenes_dslam, load_7scenes_colmap):
        monkeypatch.setenv("NEFES_NATIVE_LOADER", "0")
        pil = load("chess", root, paths["data_root"], df=8.0)
        assert not calls
        monkeypatch.setenv("NEFES_NATIVE_LOADER", "1")
        nat = load("chess", root, paths["data_root"], df=8.0)
        monkeypatch.delenv("NEFES_NATIVE_LOADER")
        default = load("chess", root, paths["data_root"], df=8.0)
        assert calls == [(len(nat.images), 60, 80)] * 2
        calls.clear()
        np.testing.assert_allclose(nat.images, pil.images, atol=2e-6)
        np.testing.assert_array_equal(default.images, nat.images)


@needs_lib
def test_native_matches_jax_package_decoder(tmp_path):
    jax_native = pytest.importorskip("nefes_tpu.native")
    if not jax_native.available():
        pytest.skip("the JAX package's native loader did not build")
    paths = _write_images(str(tmp_path))
    for H, W in ((64, 96), (32, 48), (16, 24)):
        np.testing.assert_array_equal(
            native.load_images_native(paths, H, W),
            jax_native.load_images_native(paths, H, W))


def test_unbuilt_library_falls_back(tmp_path, monkeypatch, capsys):
    """What the loaders do on a machine without libpng's headers."""
    from nefes_tpu_torch.data import load_7scenes_colmap
    from nefes_tpu_torch.data.images import load_images
    from tests.fixture_datasets import make_7scenes_fixture

    def fail():
        raise RuntimeError("g++ exited 1: png.h: No such file or directory")
    monkeypatch.setattr(native, "_build", fail)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    assert not native.available()
    assert "png.h" in native.unavailable_reason()
    assert capsys.readouterr().out.count("[native] loader unavailable") == 1
    paths = make_7scenes_fixture(str(tmp_path), frames_per_seq=2)
    monkeypatch.delenv("NEFES_NATIVE_LOADER", raising=False)
    scene = load_7scenes_colmap("chess", osp.dirname(paths["datadir"]),
                                paths["data_root"], df=8.0)
    assert "PIL fallback" in capsys.readouterr().out
    np.testing.assert_array_equal(
        scene.images, load_images(scene.image_paths, 8.0, 60, 80))
