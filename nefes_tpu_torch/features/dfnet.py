"""DFNet: the VGG16-hypercolumn feature extractor and absolute pose
regressor (APR); port of nefes_tpu/features/dfnet.py (reference
script/feature/dfnet.py).

Hypercolumn taps: conv1_2, conv3_3 and conv5_3 before their ReLU. Each tap
goes through an AdaptBlock (1×1 conv -> ReLU -> 5×5 conv -> BN) and is
bilinearly upsampled with align_corners=True to a common size. The pose
head averages the map after the fifth 2×2 max-pool over H and W and
applies fc_pose (12 = a flattened 3×4 pose).

Plain torch.nn and cuDNN convolutions: the JAX package runs these outside
any Pallas kernel. Images and features are channels-last (B, H, W, C), as
in the JAX package; the convolutions run on a channels-first view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nefes_tpu_torch.utils.image import resize_bilinear

# VGG16 conv plan: (name, out_channels); "M" = 2×2 max-pool
VGG16_PLAN = (
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
)
HYPERCOLUMN_TAPS = ("conv1_2", "conv3_3", "conv5_3")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(conv: nn.Conv2d, h: torch.Tensor, dtype) -> torch.Tensor:
    return F.conv2d(h.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class AdaptBlock(nn.Module):
    """1×1 conv -> ReLU -> 5×5 conv -> BN. BN normalises with the running
    statistics, or with the batch's own (train_bn) without updating the
    running ones."""

    def __init__(self, in_channels: int, output_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 1)
        self.conv2 = nn.Conv2d(64, output_dim, 5, padding=2)
        # flax BatchNorm(momentum=0.9) is torch momentum 0.1
        self.bn = nn.BatchNorm2d(output_dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, dtype=torch.float32,
                train_bn: bool = False) -> torch.Tensor:
        """x (B, C, H, W) -> (B, output_dim, H, W)."""
        h = _conv(self.conv2, torch.relu(_conv(self.conv1, x, dtype)), dtype)
        bn = self.bn
        # in f32, or in f64 for an f64 DFNet (flax's BN computes in the
        # module's dtype there)
        return F.batch_norm(
            h.to(torch.promote_types(h.dtype, torch.float32)),
            None if train_bn else bn.running_mean,
            None if train_bn else bn.running_var, bn.weight, bn.bias,
            training=train_bn, eps=bn.eps).to(dtype)


class DFNet(nn.Module):
    """Feature extractor and APR. forward returns (features | None,
    pose (B, 12) | None); features are (3, B, H', W', output_dim) when
    upsampled to (H', W'), else the list of the three levels."""

    def __init__(self, output_dim: int = 128, feat_dim: int = 12,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        # the ImageNet statistics live on the module's device: a copy
        # from the host on every call could not be captured in a CUDA graph
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        ch = 3
        for item in VGG16_PLAN:
            if item != "M":
                name, out = item
                self.add_module(name, nn.Conv2d(ch, out, 3, padding=1))
                ch = out
        for i, tap_channels in enumerate((64, 256, 512)):
            self.add_module(f"adapt_{i}", AdaptBlock(tap_channels, output_dim))
        self.fc_pose = nn.Linear(512, feat_dim)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw every conv and linear weight and bias from `generator`
        (uniform with the fan-in bound of PyTorch's default init)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = mod.weight[0].numel() ** -0.5
                for t in (mod.weight, mod.bias):
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)

    def forward(self, x: torch.Tensor, return_feature: bool = True,
                return_pose: bool = True, upsample_hw: tuple | None = None,
                train_bn: bool = False):
        """x (B, H, W, 3) RGB in [0, 1]."""
        if return_pose:
            # the pose head averages conv5_3 after five 2×2 pools
            assert x.shape[1] >= 32 and x.shape[2] >= 32, (
                f"DFNet pose head needs >=32x32 input, got "
                f"{x.shape[1]}x{x.shape[2]}")
        mean = self.rgb_mean.to(x.dtype)
        std = self.rgb_std.to(x.dtype)
        h = ((x - mean) / std).to(self.dtype).permute(0, 3, 1, 2)
        taps = []
        for item in VGG16_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2)
                continue
            name = item[0]
            h = _conv(getattr(self, name), h, self.dtype)
            if name in HYPERCOLUMN_TAPS:
                taps.append(h)                      # before the ReLU
            h = torch.relu(h)
            if name == "conv5_3" and not return_pose:
                break

        features = None
        if return_feature:
            ups = []
            for i, tap in enumerate(taps):
                a = getattr(self, f"adapt_{i}")(tap.float(), self.dtype,
                                                train_bn)
                a = a.permute(0, 2, 3, 1)
                if upsample_hw is not None:
                    a = resize_bilinear(a, *upsample_hw, align_corners=True)
                ups.append(a)
            features = torch.stack(ups) if upsample_hw is not None else ups

        pose = None
        if return_pose:
            g = h.mean(dim=(2, 3)).float()          # adaptive avg-pool to 1
            pose = self.fc_pose(g)
        return features, pose


def extract_target_features(dfnet: DFNet, images: torch.Tensor, H: int,
                            W: int, levels: tuple[int, ...] = (0,)
                            ) -> torch.Tensor:
    """The DFM loss target: DFNet features of (B, h, w, 3) images at
    (H, W), the chosen hypercolumn levels concatenated along channels.
    Returns (B, H, W, len(levels)·output_dim)."""
    feats, _ = dfnet(images, return_feature=True, return_pose=False,
                     upsample_hw=(H, W))
    return torch.cat([feats[lv] for lv in levels], dim=-1)
