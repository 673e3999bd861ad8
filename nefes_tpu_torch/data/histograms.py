"""Luminance histograms, the NeRF-Hist appearance signal the exposure MLP
reads; numpy copy of nefes_tpu/data/histograms.py (reference
dataset_loaders/seven_scenes.py:352-358, the YUV Y channel of kornia's
rgb_to_yuv)."""

from __future__ import annotations

import numpy as np

# BT.601 luma coefficients (kornia rgb_to_yuv)
_YUV_Y = (0.299, 0.587, 0.114)


def luminance(img_hwc: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) in [0, 1] -> Y channel (H, W)."""
    r, g, b = img_hwc[..., 0], img_hwc[..., 1], img_hwc[..., 2]
    return _YUV_Y[0] * r + _YUV_Y[1] * g + _YUV_Y[2] * b


def luminance_histogram(img_hwc: np.ndarray, bins: int = 10) -> np.ndarray:
    """Rounded percent-density luminance histogram, (bins,): torch.histc(y,
    bins, min=0, max=1) / sum · 100, rounded (values equal to 1 fall in
    the last bin, as np.histogram puts them)."""
    y = luminance(img_hwc)
    hist, _ = np.histogram(y, bins=bins, range=(0.0, 1.0))
    hist = hist.astype(np.float32)
    hist = hist / hist.sum() * 100.0
    return np.round(hist).astype(np.float32)
