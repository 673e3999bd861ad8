"""mp4 video writing for the render-video paths; port of
nefes_tpu/utils/video.py.

The reference's ``imageio.mimwrite(... .mp4, fps=15)`` calls
(script/run_nefes.py:360-364,407-411 via rendering.py render_test) become
cv2.VideoWriter with the mp4v codec, which OpenCV's bundled FFMPEG opens
headless (no ffmpeg binary or imageio needed).
"""

from __future__ import annotations

import os

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, the reference's to8b helper."""
    return (255.0 * np.clip(np.asarray(x, np.float64), 0.0, 1.0)).astype(
        np.uint8)


def write_mp4(path: str, frames: np.ndarray, fps: int = 15) -> str:
    """Write (N, H, W, 3) float [0,1] or uint8 RGB frames (or (N, H, W)
    grayscale) as an mp4. Returns the path written."""
    import cv2

    frames = np.asarray(frames)
    if frames.ndim == 3:                      # grayscale -> rgb
        frames = np.repeat(frames[..., None], 3, axis=-1)
    if frames.dtype != np.uint8:
        frames = to8b(frames)
    n, h, w = frames.shape[:3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path!r}")
    try:
        for i in range(n):
            writer.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return path


def read_mp4(path: str) -> np.ndarray:
    """Read an mp4 back as (N, H, W, 3) uint8 RGB (test helper)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
