"""Image resizes with torch's interpolation semantics, on channels-last
images; port of nefes_tpu/utils/image.py.

  resize_bilinear(align_corners=True)  nn.UpsamplingBilinear2d (the DFNet
                                       feature upsample)
  resize_bicubic                       F.interpolate(mode="bicubic"):
                                       A = -0.75, half-pixel centres,
                                       clamped borders (the refinement's
                                       feature and rgb upsample)

Each axis is resized by one small dense (out, in) interpolation matrix,
as in the JAX package, so the two agree to summation order and the
gradient is a product too. The matrices are built once per size with
numpy and kept on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _linear_weights(in_size: int, out_size: int, align_corners: bool):
    """(idx0, idx1, w1) of 1-D linear interpolation."""
    if align_corners and out_size > 1:
        x = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        x = np.maximum((np.arange(out_size) + 0.5) * scale - 0.5, 0.0)
    i0 = np.clip(np.floor(x).astype(np.int32), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (x - i0).astype(np.float32)


def _cubic_kernel(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """torch's bicubic kernel (A = -0.75)."""
    at = np.abs(t)
    w = np.where(
        at <= 1.0,
        ((A + 2.0) * at - (A + 3.0)) * at * at + 1.0,
        np.where(at < 2.0, (((at - 5.0) * at + 8.0) * at - 4.0) * A, 0.0))
    return w.astype(np.float32)


def _cubic_weights(in_size: int, out_size: int):
    """(idx (out, 4), w (out, 4)) of torch's half-pixel bicubic."""
    x = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(x).astype(np.int32)
    t = (x - x0).astype(np.float32)
    offs = np.array([-1, 0, 1, 2])
    w = _cubic_kernel(t[:, None] - offs[None, :].astype(np.float32))
    idx = np.clip(x0[:, None] + offs[None, :], 0, in_size - 1)  # clamped
    return idx, w


@functools.lru_cache(maxsize=None)
def _matrix(kind: str, in_size: int, out_size: int, device: str,
            align_corners: bool = False) -> torch.Tensor:
    """Dense (out, in) f32 interpolation matrix; clamped border taps that
    repeat an index add up."""
    if kind == "cubic":
        idx, w = _cubic_weights(in_size, out_size)
    else:
        i0, i1, w1 = _linear_weights(in_size, out_size, align_corners)
        idx = np.stack([i0, i1], axis=1)
        w = np.stack([1.0 - w1, w1], axis=1).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    for k in range(idx.shape[1]):
        np.add.at(m, (np.arange(out_size), idx[:, k]), w[:, k])
    return torch.from_numpy(m).to(device)


def _resize_axis(img: torch.Tensor, axis: int, m: torch.Tensor):
    moved = torch.movedim(img, axis, -1)
    return torch.movedim(moved @ m.to(img.dtype).t(), -1, axis)


def resize_bilinear(img: torch.Tensor, H: int, W: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., H', W', C)."""
    dev = str(img.device)
    img = _resize_axis(img, img.ndim - 3, _matrix(
        "linear", img.shape[-3], H, dev, align_corners))
    return _resize_axis(img, img.ndim - 2, _matrix(
        "linear", img.shape[-2], W, dev, align_corners))


def resize_bicubic(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """torch-semantics bicubic (A = -0.75, half-pixel) of (..., H, W, C)."""
    dev = str(img.device)
    img = _resize_axis(img, img.ndim - 3,
                       _matrix("cubic", img.shape[-3], H, dev))
    return _resize_axis(img, img.ndim - 2,
                        _matrix("cubic", img.shape[-2], W, dev))
