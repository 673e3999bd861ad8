"""SSIM of the refinement's verification fail-safe; port of
nefes_tpu/utils/ssim.py (reference script/utils/utils.py:15-49): 7×7 mean
windows over reflection padding, C1 = 0.01², C2 = 0.03², clamped to
[0, 1]. Channels-last (N, H, W, C) images, as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_K = 7
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map (N, H, W, C) of two NHWC images."""
    p = _K // 2

    def pool(a):
        return F.avg_pool2d(a, _K, stride=1)

    x = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    y = F.pad(y.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x * mu_x
    sigma_y = pool(y * y) - mu_y * mu_y
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x ** 2 + mu_y ** 2 + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp(n / d, 0.0, 1.0).permute(0, 2, 3, 1)
