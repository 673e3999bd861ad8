"""The APR zoo behind ``--PoseEstimatorType`` (reference
script/dm/pose_model.py:226-380); port of nefes_tpu/features/posenet.py.

Every model takes (B, H, W, 3) RGB in [0, 1] and normalises it with the
ImageNet statistics itself (one convention for the zoo, as in the JAX
package). Outputs follow the reference:

  PoseNetV2 / EfficientNetB3APR / PoseNetRes34 / MapNet  (B, 12), a
      flattened 3x4 pose (MapNet through the quaternion exp map of
      PoseNetMapNetStyle's (B, 6) [xyz, logq])
  PoseNetV2Feat / EfficientNetB3Feat  ([features (S, B, h, w, C)], pose)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from nefes_tpu_torch.features.backbones import (
    EfficientNet, MobileNetV2, ResNet34, init_uniform_,
)
from nefes_tpu_torch.geometry.se3 import quat_to_rotmat

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ImageNetAPR(nn.Module):
    """Base of the zoo: the ImageNet statistics as non-persistent buffers
    (a copy from the host in the forward could not be captured in a CUDA
    graph), seeded initialisation, the device."""

    def _finish(self, device, generator: torch.Generator | None) -> None:
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_uniform_(self, generator)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> ImageNet-normalised (B, 3, H, W)."""
        x = (x - self.rgb_mean.to(x.dtype)) / self.rgb_std.to(x.dtype)
        return x.permute(0, 3, 1, 2)


def _streams(fe: torch.Tensor, single_stream: bool) -> torch.Tensor:
    """(B, C, h, w) -> (S, B', h, w, C): S = 1, or the target/render
    siamese split S = 2 (the _aggregate_feature2 layout, channels last)."""
    fe = fe.permute(0, 2, 3, 1)
    if single_stream:
        return fe[None]
    b = fe.shape[0] // 2
    return torch.stack([fe[:b], fe[b:]])


class PoseNetV2(ImageNetAPR):
    """MobileNetV2 + fc_pose (1280 -> 12) (pose_model.py:247-260)."""

    def __init__(self, feat_dim: int = 12, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = MobileNetV2()
        self.fc_pose = nn.Linear(1280, feat_dim)
        self._finish(device, generator)

    def forward(self, x, train: bool = False):
        return self.fc_pose(self.backbone(self.normalize(x), train))


class EfficientNetB3APR(ImageNetAPR):
    """EfficientNet-B3 + fc_pose (1536 -> 12) (pose_model.py:226-244)."""

    def __init__(self, feat_dim: int = 12, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = EfficientNet("b3")
        self.fc_pose = nn.Linear(1536, feat_dim)
        self._finish(device, generator)

    def forward(self, x, train: bool = False):
        return self.fc_pose(self.backbone(self.normalize(x), train))


class PoseNetRes34(ImageNetAPR):
    """ResNet34 -> fc (512 -> 2048) -> relu [-> dropout] -> fc_pose (12)
    (pose_model.py:263-294; droprate 0 in the reported results; dropout
    only when training)."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.0,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.droprate = droprate
        self.backbone = ResNet34()
        self.fc = nn.Linear(512, feat_dim)
        self.fc_pose = nn.Linear(feat_dim, 12)
        self._finish(device, generator)

    def forward(self, x, train: bool = False):
        g = F.relu(self.fc(self.backbone(self.normalize(x), train)))
        if self.droprate > 0 and train:
            g = F.dropout(g, self.droprate, training=True)
        return self.fc_pose(g)


class PoseNetV2Feat(ImageNetAPR):
    """The legacy feature-tap PoseNetV2 (reference feature/model.py:10-70):
    the pose and torchvision features[17]'s map (block 16) for DFM
    training. Returns (feature levels, pose)."""

    def __init__(self, feat_dim: int = 12, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = MobileNetV2()
        self.fc_pose = nn.Linear(1280, feat_dim)
        self._finish(device, generator)

    def forward(self, x, train: bool = False, return_feature: bool = True,
                single_stream: bool = True):
        g, tap = self.backbone(self.normalize(x), train, return_tap=16)
        pose = self.fc_pose(g)
        if not return_feature:
            return [], pose
        return [_streams(tap, single_stream)], pose


class EfficientNetB3Feat(ImageNetAPR):
    """The legacy feature-tap EfficientNet-B3 APR (feature/model.py:
    72-126): feature_block selects a reduction endpoint (6: the head's
    map)."""

    def __init__(self, feat_dim: int = 12, feature_block: int = 6,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.feature_block = feature_block
        self.backbone = EfficientNet("b3")
        self.fc_pose = nn.Linear(1536, feat_dim)
        self._finish(device, generator)

    def forward(self, x, train: bool = False, return_feature: bool = True,
                single_stream: bool = True):
        head, endpoints = self.backbone(self.normalize(x), train,
                                        return_endpoints=True)
        fe = (head if self.feature_block == 6
              else endpoints[f"reduction_{self.feature_block}"])
        pose = self.fc_pose(head.mean(dim=(2, 3)))
        if not return_feature:
            return [], pose
        return [_streams(fe, single_stream)], pose


class PoseNetMapNetStyle(ImageNetAPR):
    """The MapNet paper's PoseNet: ResNet34 -> fc (2048) -> relu ->
    {fc_xyz (3), fc_wpqr (3, log quaternion)} (pose_model.py:297-333)."""

    def __init__(self, feat_dim: int = 2048, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = ResNet34()
        self.fc = nn.Linear(512, feat_dim)
        self.fc_xyz = nn.Linear(feat_dim, 3)
        self.fc_wpqr = nn.Linear(feat_dim, 3)
        self._finish(device, generator)

    def forward(self, x, train: bool = False):
        g = F.relu(self.fc(self.backbone(self.normalize(x), train)))
        return torch.cat([self.fc_xyz(g), self.fc_wpqr(g)], dim=-1)


def qexp(logq: torch.Tensor) -> torch.Tensor:
    """Quaternion exp map (N, 3) log q -> (N, 4) wxyz: [cos |q|,
    sinc(|q|/π)·q] (MapNet.qexp, pose_model.py:372-380)."""
    n = torch.sqrt(torch.sum(logq ** 2, dim=-1, keepdim=True) + 1e-24)
    return torch.cat([torch.cos(n), torch.sinc(n / math.pi) * logq], -1)


def mapnet_output_to_pose12(out6: torch.Tensor) -> torch.Tensor:
    """(N, 6) [xyz, logq] -> (N, 12) flattened 3x4 (MapNet.forward,
    pose_model.py:349-370)."""
    R = quat_to_rotmat(qexp(out6[:, 3:]))
    return torch.cat([R, out6[:, :3, None]], dim=-1).reshape(-1, 12)


class MapNet(nn.Module):
    """image -> PoseNetMapNetStyle (which normalises) -> (B, 12)."""

    def __init__(self, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mapnet = PoseNetMapNetStyle(device=device, generator=generator)

    def forward(self, x, train: bool = False):
        return mapnet_output_to_pose12(self.mapnet(x, train))
