"""Image reading for the dataset loaders, as the JAX loaders' PIL route
reads (nefes_tpu/data/seven_scenes.py:42-62, cambridge.py:30-55): Pillow
decodes, OpenCV resizes (INTER_AREA for images and masks, INTER_NEAREST
for Kinect depth) and erodes. Cambridge reads through it; the 7-Scenes
colour images go through the native decoder (nefes_tpu_torch/native)
first and fall back to it (data/seven_scenes.py). Imported when called,
not with the module."""

from __future__ import annotations

import numpy as np


def read_image(path: str) -> np.ndarray:
    """np.asarray(PIL.Image.open(path)): (H, W[, C]) uint8, or uint16 /
    int32 for 16-bit grey."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img)


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)."""
    import cv2
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)."""
    import cv2
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)


def erode(img: np.ndarray, k: int = 7) -> np.ndarray:
    """cv2.erode with a k×k box of ones, once."""
    import cv2
    return cv2.erode(img, np.ones((k, k), np.uint8), iterations=1)


def load_images(paths: list[str], df: float, h: int, w: int) -> np.ndarray:
    """Colour images -> (N, h, w, 3) float32 in [0, 1], area-resized
    unless df is 1."""
    imgs = []
    for p in paths:
        img = np.asarray(read_image(p), dtype=np.float32)[..., :3] / 255.0
        imgs.append(resize_area(img, h, w) if df != 1.0 else img)
    return np.stack(imgs)
