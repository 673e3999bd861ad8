"""Image augmentations — torchvision-semantics ColorJitter; port of
nefes_tpu/data/augment.py.

Reference: dataset_loaders/cambridge_scenes.py:263-264 creates
``transforms.ColorJitter(brightness=(0.2,1.3), contrast=(0.8,1.5),
saturation=(1.0,2.5))`` to mimic exposure variation for APR training
(the NeRF dataloader asserts it OFF, load_Cambridge.py:410 — same rule
applies here: this is for the APR/feature-training path only).

torchvision semantics: per-op factor uniform in its range, ops applied in
a random permutation, each op a clamped blend — brightness vs black,
contrast vs the mean of the grayscale image, saturation vs the per-pixel
grayscale. The factors and the permutation come from a
numpy.random.Generator in the JAX package's order, so that one seed
gives both packages the same jitter; the blends run on the image's
device.
"""

from __future__ import annotations

import numpy as np
import torch

BRIGHTNESS = (0.2, 1.3)
CONTRAST = (0.8, 1.5)
SATURATION = (1.0, 2.5)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over x's last axis in numpy's float pairwise order (blocks of
    up to 128 in 8 running sums, halves above that)."""
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[..., :8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    half = n // 2 - (n // 2) % 8
    return _pairwise_sum(x[..., :half]) + _pairwise_sum(x[..., half:])


def _image_mean(x: torch.Tensor) -> torch.Tensor:
    """x (..., H, W, 1) -> its mean over (H, W, 1), keepdims, summed as
    numpy sums a float32 image (pairwise within each np.getbufsize()
    chunk, the chunks in turn), so that the contrast blend is the JAX
    package's to the bit."""
    flat = x.reshape(*x.shape[:-3], -1)
    step = np.getbufsize()
    total = None
    for i in range(0, flat.shape[-1], step):
        part = _pairwise_sum(flat[..., i:i + step])
        total = part if total is None else total + part
    return (total / flat.shape[-1])[..., None, None, None]


def _blend(a, b, factor: float) -> torch.Tensor:
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def color_jitter(img: torch.Tensor, rng: np.random.Generator | None = None,
                 brightness=BRIGHTNESS, contrast=CONTRAST,
                 saturation=SATURATION) -> torch.Tensor:
    """img: (..., H, W, 3) float in [0, 1]. Returns the jittered copy
    (f32)."""
    rng = rng or np.random.default_rng()
    img = img.float()
    ops = []
    if brightness:
        b = rng.uniform(*brightness)
        ops.append(lambda x: _blend(x, torch.zeros_like(x), b))
    if contrast:
        c = rng.uniform(*contrast)
        ops.append(lambda x: _blend(
            x, _image_mean(_grayscale(x)), c))
    if saturation:
        s = rng.uniform(*saturation)
        ops.append(lambda x: _blend(x, _grayscale(x), s))
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img
