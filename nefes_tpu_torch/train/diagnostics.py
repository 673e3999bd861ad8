"""Training-health diagnostics; port of nefes_tpu/train/diagnostics.py.

FusionNet (reference nerfh_nff.py:356-418: conv-relu x3 -> conv5x5 ->
BatchNorm) can train into a collapsed state: one conv layer's ReLUs all
dead, the output the last conv's bias (a constant map), kept there by
the trailing BN's bias absorbing the loss. A constant fused output makes
the refinement's DFM loss pose-independent, so its gradient is zero and
both refinement modes do nothing. In a trained checkpoint the sign is a
BN running variance near zero (~1e-10).

`fusion_conv_liveness` measures each conv's share of live (positive)
ReLU outputs on a real input, so that a harness or training loop can
detect the collapse instead of shipping an inert model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fusion_conv_liveness"]


@torch.no_grad()
def fusion_conv_liveness(fusion, rgb_img: torch.Tensor,
                         feat: torch.Tensor) -> dict[str, float]:
    """Share of positive post-ReLU activations per FusionNet conv.

    fusion: a model's FusionNet (model.fusion); rgb_img (H, W, 3) rendered
    RGB in [0, 1] (before the ImageNet normalisation FusionNet applies);
    feat (H, W, F) the rendered feature map. Returns {'conv0': share,
    'conv1': share, 'conv2': share} (the convs in f32, the shares exact);
    0.0 for a layer means every ReLU is dead and the DFM gradient through
    the fused output is zero."""
    mean = fusion.rgb_mean.float()
    std = fusion.rgb_std.float()
    x = torch.cat([(rgb_img.float() - mean) / std, feat.float()], dim=-1)
    x = x.permute(2, 0, 1)[None]                                  # NCHW
    live = {}
    for name in ("conv0", "conv1", "conv2"):
        conv = getattr(fusion, name)
        x = torch.relu(F.conv2d(x, conv.weight.float(), conv.bias.float(),
                                padding=conv.padding))
        live[name] = float(torch.mean((x > 0).double()))
    return live
