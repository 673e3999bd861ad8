"""Plain reference of DFNet (Chen et al., ECCV 2022): VGG16 with
hypercolumn taps at conv1_2, conv3_3 and conv5_3 (before their ReLU),
each through a 1x1 conv, ReLU, 5x5 conv and BatchNorm on running
statistics, upsampled bilinearly (align_corners) to a common size; the
pose head averages conv5_3's map after the fifth pool and applies a
linear layer to a flattened 3x4 pose. The layer names are the program's.

`dtype` is the compute dtype: float32, or bfloat16 for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nefes import resize_bilinear_ac

VGG16_PLAN = (
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
)
TAPS = ("conv1_2", "conv3_3", "conv5_3")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _conv(conv, h, dtype):
    return F.conv2d(h.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class AdaptBlock(nn.Module):
    def __init__(self, cin: int, out: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 64, 1)
        self.conv2 = nn.Conv2d(64, out, 5, padding=2)
        self.bn = nn.BatchNorm2d(out, eps=1e-5)

    def forward(self, x, dtype):
        h = _conv(self.conv2, torch.relu(_conv(self.conv1, x, dtype)), dtype)
        bn = self.bn
        return F.batch_norm(h.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, training=False,
                            eps=bn.eps).to(dtype)


class DFNet(nn.Module):
    def __init__(self, output_dim: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("rgb_mean", torch.tensor(MEAN), persistent=False)
        self.register_buffer("rgb_std", torch.tensor(STD), persistent=False)
        ch = 3
        for item in VGG16_PLAN:
            if item != "M":
                self.add_module(item[0], nn.Conv2d(ch, item[1], 3, padding=1))
                ch = item[1]
        for i, c in enumerate((64, 256, 512)):
            self.add_module(f"adapt_{i}", AdaptBlock(c, output_dim))
        self.fc_pose = nn.Linear(512, 12)

    def _trunk(self, x, stop_at_conv5: bool):
        h = ((x - self.rgb_mean) / self.rgb_std).to(self.dtype)
        h = h.permute(0, 3, 1, 2)
        taps = []
        for item in VGG16_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2)
                continue
            h = _conv(getattr(self, item[0]), h, self.dtype)
            if item[0] in TAPS:
                taps.append(h)
            h = torch.relu(h)
            if item[0] == "conv5_3" and stop_at_conv5:
                break
        return h, taps

    def pose(self, x):
        """(B, H, W, 3) -> (B, 3, 4)."""
        h, _ = self._trunk(x, False)
        return self.fc_pose(h.mean(dim=(2, 3)).float()).reshape(-1, 3, 4)

    def features(self, x, H: int, W: int, level: int = 0):
        """Hypercolumn level `level` of (B, h, w, 3) at (H, W): (B, H, W,
        output_dim)."""
        _, taps = self._trunk(x, True)
        a = getattr(self, f"adapt_{level}")(taps[level].float(), self.dtype)
        return resize_bilinear_ac(a.permute(0, 2, 3, 1), H, W)
