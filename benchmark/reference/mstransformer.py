"""Plain reference of the MS-Transformer APR (Shavit et al., ICCV 2021;
the multi-scene TransPoseNet of
github.com/yolish/multi-scene-pose-transformer):
an EfficientNet-B0 backbone tapped at reduction_4 (translation) and
reduction_3 (rotation), per branch a 1x1 projection, learned row / col
position embeddings and 6 pre-norm encoder + 6 decoder layers (width 256,
4 heads, feed-forward 256, exact GELU, LayerNorm eps 1e-6), per-scene
regressor heads chosen by the argmax scene; the 7-Scenes output is the
translation and the rotation of the quaternion. A frozen copy of the
program's plain modules with the program's layer names; `dtype` is the
compute dtype of the network's layers (bfloat16 for the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


def _linear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) bilinear interpolation, half-pixel centres."""
    x = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    m = np.zeros((n_out, n_in), np.float64)
    np.add.at(m, (np.arange(n_out), i0), 1.0 - (x - i0))
    np.add.at(m, (np.arange(n_out), i1), x - i0)
    return torch.tensor(m, dtype=torch.float32, device=device)


def resize_bilinear(img, H: int, W: int):
    """(B, h, w, C) -> (B, H, W, C), bilinear, half-pixel centres."""
    mh = _linear_matrix(img.shape[1], H, img.device)
    mw = _linear_matrix(img.shape[2], W, img.device)
    return torch.einsum("Hh,bhwc,Ww->bHWc", mh, img.float(), mw)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z), normalised -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-8)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


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
        return h.mean(dim=(2, 3))


def preprocess_mstransformer(img: torch.Tensor, mean: torch.Tensor,
                             std: torch.Tensor) -> torch.Tensor:
    """Resize the shorter side to 256, centre-crop 224, ImageNet-normalise
    (the torchvision transforms at transposenet.py:96-101). img (B, H, W,
    3) in [0, 1]; mean / std (3,) on its device."""
    _, H, W, _ = img.shape
    if H < W:
        nh, nw = 256, max(1, round(W * 256 / H))
    else:
        nh, nw = max(1, round(H * 256 / W)), 256
    img = resize_bilinear(img, nh, nw)
    top, left = (nh - 224) // 2, (nw - 224) // 2
    img = img[:, top:top + 224, left:left + 224]
    return (img - mean.to(img.dtype)) / std.to(img.dtype)


class MHA(nn.Module):
    """Multi-head attention: q, k, v projected to (heads, width / heads),
    softmax(q k / sqrt(width / heads)), an output projection."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.attn = nn.ModuleDict({k: nn.Linear(d_model, d_model)
                                   for k in ("query", "key", "value", "out")})

    def forward(self, q, k, v):
        """q (B, Lq, d), k / v (B, Lk, d) -> (B, Lq, d)."""
        B, Lq, d = q.shape
        hd = d // self.nhead

        def heads(x, name):
            return self.attn[name](x).reshape(B, -1, self.nhead,
                                              hd).transpose(1, 2)
        qh = heads(q, "query") / hd ** 0.5
        w = torch.softmax(qh @ heads(k, "key").transpose(-1, -2), dim=-1)
        out = (w @ heads(v, "value")).transpose(1, 2).reshape(B, Lq, d)
        return self.attn["out"](out)


def _ffn(d_model: int, ffn: int) -> dict:
    return {"linear1": nn.Linear(d_model, ffn),
            "linear2": nn.Linear(ffn, d_model)}


class EncoderLayer(nn.Module):
    """Pre-norm DETR encoder layer (transformer_encoder.py)."""

    def __init__(self, d_model: int = 256, nhead: int = 4, ffn: int = 256):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MHA(d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        for name, mod in _ffn(d_model, ffn).items():
            self.add_module(name, mod)

    def forward(self, src, pos):
        h = self.norm1(src)
        qk = h + pos
        src = src + self.self_attn(qk, qk, h)
        h = self.linear2(F.gelu(self.linear1(self.norm2(src))))
        return src + h


class DecoderLayer(nn.Module):
    """Pre-norm DETR decoder layer."""

    def __init__(self, d_model: int = 256, nhead: int = 4, ffn: int = 256):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = MHA(d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MHA(d_model, nhead)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        for name, mod in _ffn(d_model, ffn).items():
            self.add_module(name, mod)

    def forward(self, tgt, memory, pos, query_pos):
        h = self.norm1(tgt)
        qk = h + query_pos
        tgt = tgt + self.self_attn(qk, qk, h)
        h = self.norm2(tgt)
        tgt = tgt + self.cross_attn(h + query_pos, memory + pos, memory)
        h = self.linear2(F.gelu(self.linear1(self.norm3(tgt))))
        return tgt + h


class TransformerBranch(nn.Module):
    """The encoder and decoder stack of one branch (t or rot)."""

    def __init__(self, d_model: int = 256, nhead: int = 4, ffn: int = 256,
                 layers: int = 6):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"enc_{i}", EncoderLayer(d_model, nhead, ffn))
        self.enc_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        for i in range(layers):
            self.add_module(f"dec_{i}", DecoderLayer(d_model, nhead, ffn))
        self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, query):
        """src / pos (B, S, C), query (Q, C) -> (B, Q, C)."""
        h = src
        for i in range(self.layers):
            h = getattr(self, f"enc_{i}")(h, pos)
        memory = self.enc_norm(h)
        q = query[None].expand(src.shape[0], *query.shape)
        tgt = torch.zeros_like(q)
        for i in range(self.layers):
            tgt = getattr(self, f"dec_{i}")(tgt, memory, pos, q)
        return self.dec_norm(tgt)


class LearnedPosEmbed2D(nn.Module):
    """DETR's learned row / col position embedding (pencoder.py:148-173):
    channels [col_embed(x) ⊕ row_embed(y)], each d_model / 2."""

    def __init__(self, d_model: int = 256, max_hw: int = 50):
        super().__init__()
        half = d_model // 2
        self.row_embed = nn.Parameter(torch.zeros(max_hw, half))
        self.col_embed = nn.Parameter(torch.zeros(max_hw, half))

    def forward(self, h: int, w: int) -> torch.Tensor:
        """-> (h, w, d_model)."""
        half = self.row_embed.shape[1]
        x_emb = self.col_embed[None, :w].expand(h, w, half)
        y_emb = self.row_embed[:h, None].expand(h, w, half)
        return torch.cat([x_emb, y_emb], dim=-1)


class PoseRegressor(nn.Module):
    """width -> 1024 -> GELU -> out_dim (transposenet.py:17-49)."""

    def __init__(self, d_model: int, out_dim: int):
        super().__init__()
        self.fc_h = nn.Linear(d_model, 1024)
        self.fc_o = nn.Linear(1024, out_dim)

    def forward(self, x):
        return self.fc_o(F.gelu(self.fc_h(x)))


class MultiScenePoseRegressor(nn.Module):
    """num_scenes PoseRegressor heads stacked, each sample's head gathered
    by its scene index (the reference loops over the batch,
    transposenet.py:176-180). Kernels in flax's (in, out) layout."""

    def __init__(self, num_scenes: int, out_dim: int, d_model: int = 256):
        super().__init__()
        self.fc_h_kernel = nn.Parameter(torch.zeros(num_scenes, d_model,
                                                    1024))
        self.fc_h_bias = nn.Parameter(torch.zeros(num_scenes, 1024))
        self.fc_o_kernel = nn.Parameter(torch.zeros(num_scenes, 1024,
                                                    out_dim))
        self.fc_o_bias = nn.Parameter(torch.zeros(num_scenes, out_dim))

    def forward(self, x, scene_idx):
        """x (B, C), scene_idx (B,) int64 -> (B, out_dim)."""
        h = torch.einsum("bc,bco->bo", x,
                         self.fc_h_kernel.index_select(0, scene_idx))
        h = F.gelu(h + self.fc_h_bias.index_select(0, scene_idx))
        return (torch.einsum("bc,bco->bo", h,
                             self.fc_o_kernel.index_select(0, scene_idx))
                + self.fc_o_bias.index_select(0, scene_idx))


BRANCHES = (("t", 112, 3), ("rot", 40, 4))  # (branch, backbone tap ch, out)


class MSTransPoseNet(nn.Module):
    """Multi-scene TransPoseNet (transposenet.py:52-201). forward returns
    {"pose" (B, 7) [xyz, quat wxyz], "scene_log_distr" (B, S),
    "max_indices" (B,)}; with dtype bfloat16 its layers run under
    autocast."""

    def __init__(self, num_scenes: int = 7, d_model: int = 256,
                 nhead: int = 4, ffn: int = 256, layers: int = 6,
                 dtype=torch.float32):
        super().__init__()
        self.backbone = EfficientNet("b0")
        for name, cin, out in BRANCHES:
            self.add_module(f"input_proj_{name}", nn.Conv2d(cin, d_model, 1))
            self.add_module(f"pos_embed_{name}", LearnedPosEmbed2D(d_model))
            self.register_parameter(f"query_embed_{name}", nn.Parameter(
                torch.zeros(num_scenes, d_model)))
            self.add_module(f"transformer_{name}", TransformerBranch(
                d_model, nhead, ffn, layers))
            self.add_module(f"regressor_head_{name}",
                            MultiScenePoseRegressor(num_scenes, out, d_model))
        self.scene_embed = nn.Linear(2 * d_model, 1)
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.dtype = dtype

    def forward(self, img: torch.Tensor) -> dict:
        with torch.autocast(img.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self._forward(img)

    def _forward(self, img: torch.Tensor) -> dict:
        x = preprocess_mstransformer(img, self.rgb_mean, self.rgb_std)
        _, endpoints = self.backbone(x.permute(0, 3, 1, 2), False,
                                     return_endpoints=True)
        taps = {"t": endpoints["reduction_4"],      # (B, 112, 14, 14)
                "rot": endpoints["reduction_3"]}    # (B, 40, 28, 28)
        local = {}
        for name, _, _ in BRANCHES:
            proj = getattr(self, f"input_proj_{name}")(taps[name])
            B, C, h, w = proj.shape
            pos = getattr(self, f"pos_embed_{name}")(h, w).reshape(h * w, C)
            local[name] = getattr(self, f"transformer_{name}")(
                proj.flatten(2).transpose(1, 2), pos[None].expand(B, -1, -1),
                getattr(self, f"query_embed_{name}"))
        scene_logits = self.scene_embed(
            torch.cat([local["t"], local["rot"]], dim=-1))[..., 0]
        scene_log_distr = torch.log_softmax(scene_logits, dim=-1)
        max_indices = scene_log_distr.argmax(dim=-1)
        out = []
        for name, _, _ in BRANCHES:
            loc = local[name]
            glob = torch.gather(loc, 1, max_indices[:, None, None].expand(
                -1, 1, loc.shape[-1]))[:, 0]
            head = getattr(self, f"regressor_head_{name}")
            out.append(head(glob, max_indices))
        return {"pose": torch.cat(out, dim=-1).float(),
                "scene_log_distr": scene_log_distr,
                "max_indices": max_indices}


def pose_7scenes(net, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> the (3, 4) pose: the translation and the rotation of
    the chosen scene's quaternion."""
    p = net(image[None])["pose"][0]
    return torch.cat([quat_to_rotmat(p[3:]), p[:3, None]], dim=-1)
