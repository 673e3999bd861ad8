"""The GIRAFFE upsampling decoder (legacy NFF scheme 2); port of
nefes_tpu/fields/decoder.py (reference script/models/decoder.py).

n_blocks of 2x nearest-neighbour feature upsampling + 3x3 conv +
leaky ReLU, with bilinearly upsampled RGB skip connections smoothed by a
[1, 2, 1] x [1, 2, 1] blur; the last block upsamples straight to the
target (H, W). Channels-last (B, H, W, C) throughout, as in the JAX
package; the convolutions run on a channels-first view. No CLI builds it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nefes_tpu_torch.utils.image import resize_bilinear

_BLUR = np.asarray([1.0, 2.0, 1.0])


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def blur(x: torch.Tensor) -> torch.Tensor:
    """The normalised 3x3 binomial blur of each channel, zero-padded
    (reference Blur, decoder.py:6-15)."""
    k = _BLUR[:, None] * _BLUR[None, :]
    C = x.shape[-1]
    kernel = torch.as_tensor(k / k.sum(), dtype=x.dtype,
                             device=x.device).expand(C, 1, 3, 3)
    return _nchw(lambda t: F.conv2d(t, kernel, padding=1, groups=C), x)


def _nn_upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _nn_resize(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest-neighbour resize to (H, W), source index i·h // H (torch
    nn.Upsample(size=...)'s default mode, decoder.py:57)."""
    h, w = x.shape[1], x.shape[2]
    ri = torch.arange(H, device=x.device) * h // H
    ci = torch.arange(W, device=x.device) * w // W
    return x[:, ri][:, :, ci]


class GiraffeDecoder(nn.Module):
    """(B, h, w, input_dim) feature maps -> (B, H, W, out_dim) RGB.
    Convolutions carry the flax names (conv_in, conv_rgb_<i>, conv_<i>,
    conv_rgb_out)."""

    def __init__(self, n_feat: int = 128, input_dim: int = 128,
                 out_dim: int = 3, min_feat: int = 32, n_blocks: int = 4,
                 out_hw: tuple[int, int] = (240, 427),
                 use_rgb_skip: bool = True, final_actvn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks, self.out_hw = n_blocks, tuple(out_hw)
        self.use_rgb_skip, self.final_actvn = use_rgb_skip, final_actvn
        self.dtype = dtype
        self.widths = [max(n_feat // (2 ** (i + 1)), min_feat)
                       for i in range(n_blocks)]
        if n_feat != input_dim:
            self.conv_in = nn.Conv2d(input_dim, n_feat, 1)
        if use_rgb_skip:
            self.conv_rgb_0 = nn.Conv2d(input_dim, out_dim, 3, padding=1)
        ch = n_feat
        for i, wch in enumerate(self.widths):
            self.add_module(f"conv_{i}", nn.Conv2d(ch, wch, 3, padding=1))
            if use_rgb_skip:
                self.add_module(f"conv_rgb_{i + 1}",
                                nn.Conv2d(wch, out_dim, 3, padding=1))
            ch = wch
        if not use_rgb_skip:
            self.conv_rgb_out = nn.Conv2d(ch, out_dim, 3, padding=1)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        conv, dt = getattr(self, name), self.dtype
        return _nchw(lambda t: F.conv2d(
            t.to(dt), conv.weight.to(dt), conv.bias.to(dt),
            padding=conv.padding), x)

    def forward(self, x: torch.Tensor, return_hier_rgbs: bool = False):
        H, W = self.out_hw
        nb = self.n_blocks

        def up_rgb(r):
            return blur(resize_bilinear(r, r.shape[1] * 2, r.shape[2] * 2))

        def up_rgb_final(r):
            return blur(resize_bilinear(r, H, W))

        net = self._conv("conv_in", x) if hasattr(self, "conv_in") else x
        rgb = None
        if self.use_rgb_skip:
            rgb = self._conv("conv_rgb_0", x)
            rgb = up_rgb(rgb) if nb > 1 else up_rgb_final(rgb)
        rgbs = []
        for idx in range(nb):
            net_up = _nn_upsample2(net) if idx < nb - 1 \
                else _nn_resize(net, H, W)
            net = F.leaky_relu(self._conv(f"conv_{idx}", net_up), 0.2)
            if self.use_rgb_skip:
                rgb = rgb + self._conv(f"conv_rgb_{idx + 1}", net)
                if return_hier_rgbs:
                    rgbs.append(rgb)
                if idx < nb - 2:
                    rgb = up_rgb(rgb)
                elif idx == nb - 2:
                    rgb = up_rgb_final(rgb)
        if not self.use_rgb_skip:
            rgb = self._conv("conv_rgb_out", net)
        if return_hier_rgbs:
            return rgbs
        return torch.sigmoid(rgb) if self.final_actvn else rgb
