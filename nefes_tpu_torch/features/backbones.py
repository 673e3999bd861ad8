"""ImageNet CNN backbones over NCHW: ResNet34, MobileNetV2,
EfficientNet-B0/B3; port of nefes_tpu/features/backbones.py (reference
script/dm/pose_model.py:226-294).

Submodules carry the JAX package's names (``layer1_0.conv1``,
``block_3.depthwise_conv``), so that its variables map onto them by a
rule (weights.apr_from_jax_variables); features/convert_backbones.py maps
the torchvision and lukemelas checkpoints onto the same names.

  * ConvBN and ResNet34 pad symmetrically, (k - 1) // 2 a side
    (torchvision); EfficientNet pads as flax's "SAME" does, which is
    asymmetric at stride 2 on even sizes (SameConv2d).
  * BatchNorm eps 1e-5, EfficientNet's 1e-3. A BatchNorm normalises with
    its running statistics, or with train=True with the batch's own,
    leaving the running ones untouched (the JAX package discards its
    updated batch_stats, nefes_tpu/refine/apr_opt.py:85-87).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on running statistics, or train=True on the batch's own
    without updating the running ones."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.batch_norm(
            x, None if train else self.running_mean,
            None if train else self.running_var, self.weight, self.bias,
            training=train, eps=self.eps)


class SameConv2d(nn.Conv2d):
    """Conv2d with flax / TF "SAME" padding: total (ceil(n/s) - 1)·s + k - n,
    the smaller half before."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(x.shape[:-3:-1], self.kernel_size[::-1],
                           self.stride[::-1]):
            p = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [p // 2, p - p // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride,
                        0, self.dilation, self.groups)


@torch.no_grad()
def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every Conv2d and Linear weight and bias of module from
    generator, uniform within PyTorch's default fan-in bound (as DFNet's
    seeded initialisation)."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            bound = mod.weight[0].numel() ** -0.5
            for t in (mod.weight, mod.bias):
                if t is not None:
                    t.copy_(torch.rand(t.shape, generator=generator)
                            * (2 * bound) - bound)


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


class ConvBN(nn.Module):
    """conv (symmetric padding, no bias) -> BN (eps 1e-5) [-> relu6]."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride,
                              (kernel - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm(features, eps=1e-5)
        self.act = act

    def forward(self, x, train: bool = False):
        h = self.bn(self.conv(x), train)
        return F.relu6(h) if self.act else h


# --- ResNet-34 (torchvision BasicBlock layout) ---

class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features, eps=1e-5)
        self.downsample = stride != 1 or cin != features
        if self.downsample:
            self.downsample_conv = nn.Conv2d(cin, features, 1, stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(features, eps=1e-5)

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        identity = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.downsample else x)
        return F.relu(h + identity)


class ResNet34(nn.Module):
    """torchvision resnet34's feature tower: (B, 3, H, W) -> (B, 512),
    average-pooled (the fc is each APR's own)."""

    STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, eps=1e-5)
        cin = 64
        for stage, (n, feats) in enumerate(self.STAGES):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_{i}",
                                BasicBlock(cin, feats, stride))
                cin = feats

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.max_pool2d(h, 3, 2, 1)
        for stage, (n, _) in enumerate(self.STAGES):
            for i in range(n):
                h = getattr(self, f"layer{stage + 1}_{i}")(h, train)
        return _mean_hw(h)


# --- MobileNetV2 (torchvision layout) ---

class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.expand = ConvBN(cin, hidden, kernel=1)
        self.depthwise = ConvBN(hidden, hidden, 3, stride, groups=hidden)
        self.project = ConvBN(hidden, features, kernel=1, act=False)
        self.has_expand = expand != 1
        self.residual = stride == 1 and cin == features

    def forward(self, x, train: bool = False):
        h = self.expand(x, train) if self.has_expand else x
        h = self.project(self.depthwise(h, train), train)
        return h + x if self.residual else h


# (expand, out_channels, repeats, stride): MobileNetV2 paper, Table 2
MBV2_PLAN = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.Module):
    """(B, 3, H, W) -> (B, 1280) average-pooled."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 3, 2)
        cin, idx = 32, 0
        for expand, out, reps, stride in MBV2_PLAN:
            for i in range(reps):
                self.add_module(f"block_{idx}", InvertedResidual(
                    cin, out, stride if i == 0 else 1, expand))
                cin, idx = out, idx + 1
        self.n_blocks = idx
        self.head = ConvBN(cin, 1280, kernel=1)

    def forward(self, x, train: bool = False, return_tap: int = -1):
        """return_tap >= 0: also that block's output map, (pooled, tap)
        (the legacy feature-tap APRs read torchvision features[17], block
        16; reference feature/model.py:56-63)."""
        h = self.stem(x, train)
        tap = None
        for idx in range(self.n_blocks):
            h = getattr(self, f"block_{idx}")(h, train)
            if idx == return_tap:
                tap = h
        pooled = _mean_hw(self.head(h, train))
        return (pooled, tap) if return_tap >= 0 else pooled


# --- EfficientNet B0/B3 (lukemelas layout, pose_model.py:226-244) ---

def round_filters(f: int, width: float) -> int:
    f *= width
    new = max(8, int(f + 4) // 8 * 8)
    if new < 0.9 * f:
        new += 8
    return int(new)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


class MBConv(nn.Module):
    """expand 1x1 -> depthwise kxk ("SAME") -> squeeze-excite -> project
    1x1, BN eps 1e-3, SiLU."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 expand: int, se_ratio: float = 0.25):
        super().__init__()
        hidden = cin * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand_conv = nn.Conv2d(cin, hidden, 1, bias=False)
            self.bn0 = BatchNorm(hidden, eps=1e-3)
        self.depthwise_conv = SameConv2d(hidden, hidden, kernel, stride,
                                         groups=hidden, bias=False)
        self.bn1 = BatchNorm(hidden, eps=1e-3)
        se_ch = max(1, int(cin * se_ratio))
        self.se_reduce = nn.Conv2d(hidden, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, hidden, 1)
        self.project_conv = nn.Conv2d(hidden, features, 1, bias=False)
        self.bn2 = BatchNorm(features, eps=1e-3)
        self.residual = stride == 1 and cin == features

    def forward(self, x, train: bool = False):
        h = x
        if self.has_expand:
            h = F.silu(self.bn0(self.expand_conv(h), train))
        h = F.silu(self.bn1(self.depthwise_conv(h), train))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = self.se_expand(F.silu(self.se_reduce(s)))
        h = self.bn2(self.project_conv(h * torch.sigmoid(s)), train)
        return h + x if self.residual else h


# (expand, channels, repeats, stride, kernel): the EfficientNet-B0 plan
EFFNET_PLAN = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
               (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
               (6, 320, 1, 1, 3))
EFFNET_SCALING = {"b0": (1.0, 1.0), "b3": (1.2, 1.4)}   # (width, depth)


class EfficientNet(nn.Module):
    """The extract_features tower: B0's head has 1280 channels, B3's 1536."""

    def __init__(self, variant: str = "b0"):
        super().__init__()
        width, depth = EFFNET_SCALING[variant]
        cin = round_filters(32, width)
        self.stem_conv = SameConv2d(3, cin, 3, 2, bias=False)
        self.stem_bn = BatchNorm(cin, eps=1e-3)
        # (block, whether the activation before it is an endpoint)
        self.plan = []
        idx = 0
        for expand, ch, reps, stride, kernel in EFFNET_PLAN:
            ch = round_filters(ch, width)
            for i in range(round_repeats(reps, depth)):
                s = stride if i == 0 else 1
                self.add_module(f"block_{idx}",
                                MBConv(cin, ch, kernel, s, expand))
                self.plan.append((f"block_{idx}", s > 1))
                cin, idx = ch, idx + 1
        head = round_filters(1280, width)
        self.head_conv = nn.Conv2d(cin, head, 1, bias=False)
        self.head_bn = BatchNorm(head, eps=1e-3)

    def forward(self, x, train: bool = False, return_endpoints: bool = False):
        """(B, 3, H, W) -> (B, C) pooled; return_endpoints: (the head's
        map, {reduction_i: map}), where reduction_i is the activation just
        before the i-th downsampling after the stem (lukemelas
        extract_endpoints; B0's reduction_3 has 40 channels, reduction_4
        112: MS-Transformer's taps) and the last one the head's map."""
        h = F.silu(self.stem_bn(self.stem_conv(x), train))
        endpoints = {}
        for name, reduces in self.plan:
            if reduces:
                endpoints[f"reduction_{len(endpoints) + 1}"] = h
            h = getattr(self, name)(h, train)
        h = F.silu(self.head_bn(self.head_conv(h), train))
        if return_endpoints:
            endpoints[f"reduction_{len(endpoints) + 1}"] = h
            return h, endpoints
        return _mean_hw(h)
