"""The multi-scene TransPoseNet APR (MS-Transformer); port of
nefes_tpu/features/mstransformer.py (reference script/mstransformer/:
transposenet.py, transformer.py, transformer_encoder.py, pencoder.py,
backbone.py, DETR-derived).

Configuration of the official repo (transposenet.py:56-66): width 256, 4
heads, feed-forward 256, 6 + 6 encoder / decoder layers a branch,
pre-norm, exact GELU, learned row / col position embeddings, an
EfficientNet-B0 backbone tapped at reduction_4 (112 channels, the
translation branch) and reduction_3 (40, the rotation branch).

As in the JAX package:
  * LayerNorm eps is flax's 1e-6 (the reference's torch layers use 1e-5);
  * attention is flax's MultiHeadDotProductAttention: q, k, v projected to
    (heads, width / heads), softmax(q·k / √(width / heads)), an output
    projection; plain operations here;
  * each branch has its own copy of the position embedding (the reference
    shares one; features/convert_backbones.py copies it into both);
  * the per-scene regressor heads are stacked parameters gathered by the
    argmax scene, so the heads of the scenes not chosen get zero
    gradients, and an Adam step sees every head every step;
  * the image is resized with the repo's own bilinear matrices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nefes_tpu_torch.features.backbones import EfficientNet, init_uniform_
from nefes_tpu_torch.features.posenet import IMAGENET_MEAN, IMAGENET_STD
from nefes_tpu_torch.geometry.se3 import quat_to_rotmat, to_homogeneous
from nefes_tpu_torch.utils.image import resize_bilinear

LN_EPS = 1e-6       # flax nn.LayerNorm's default


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
    """flax MultiHeadDotProductAttention as plain operations; the
    projections under `attn` as in the JAX package."""

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


def pose_avg_inverse(pose_avg_stats=None) -> torch.Tensor:
    """The inverse of the 4x4 homogeneous pose_avg_stats (3, 4), in f64 on
    the host, as a (4, 4) f32 tensor; the identity for None."""
    m = np.eye(4)
    if pose_avg_stats is not None:
        if isinstance(pose_avg_stats, torch.Tensor):
            pose_avg_stats = pose_avg_stats.detach().cpu().numpy()
        m[:3] = np.asarray(pose_avg_stats, np.float64).reshape(3, 4)
    return torch.from_numpy(np.linalg.inv(m).astype(np.float32))


class MSTransPoseNet(nn.Module):
    """Multi-scene TransPoseNet (transposenet.py:52-201). forward returns
    {"pose" (B, 7) [xyz, quat wxyz], "scene_log_distr" (B, S),
    "max_indices" (B,)}. single_head: the EMS variant's one shared head.

    pose_avg_stats: the Cambridge scene's centring stats (3, 4); their
    inverse is computed once here and kept as the buffer `pose_avg_inv`
    (ems_pose_to_matrix's Cambridge conversion): torch.linalg.inv reads
    its error flag back to the host, which a CUDA graph cannot hold."""

    def __init__(self, num_scenes: int = 7, d_model: int = 256,
                 nhead: int = 4, ffn: int = 256, layers: int = 6,
                 single_head: bool = False, pose_avg_stats=None,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.single_head = single_head
        self.backbone = EfficientNet("b0")
        for name, cin, out in BRANCHES:
            self.add_module(f"input_proj_{name}", nn.Conv2d(cin, d_model, 1))
            self.add_module(f"pos_embed_{name}", LearnedPosEmbed2D(d_model))
            self.register_parameter(f"query_embed_{name}", nn.Parameter(
                torch.zeros(num_scenes, d_model)))
            self.add_module(f"transformer_{name}", TransformerBranch(
                d_model, nhead, ffn, layers))
            self.add_module(f"regressor_head_{name}", (
                PoseRegressor(d_model, out) if single_head else
                MultiScenePoseRegressor(num_scenes, out, d_model)))
        self.scene_embed = nn.Linear(2 * d_model, 1)
        self.register_buffer("rgb_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("rgb_std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.register_buffer("pose_avg_inv", pose_avg_inverse(pose_avg_stats),
                             persistent=False)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Conv / Linear as init_uniform_, the position embeddings
        U[0, 1) and the scene queries N(0, 1) (the JAX package's
        initialisers), the stacked heads' kernels uniform within their
        fan-in bound and their biases 0."""
        init_uniform_(self, generator)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("row_embed", "col_embed"):
                p.copy_(torch.rand(p.shape, generator=generator))
            elif leaf.startswith("query_embed"):
                p.copy_(torch.randn(p.shape, generator=generator))
            elif leaf in ("fc_h_kernel", "fc_o_kernel"):
                bound = p.shape[1] ** -0.5
                p.copy_(torch.rand(p.shape, generator=generator)
                        * (2 * bound) - bound)
            elif leaf in ("fc_h_bias", "fc_o_bias"):
                p.zero_()

    def forward(self, img: torch.Tensor, train: bool = False) -> dict:
        x = preprocess_mstransformer(img, self.rgb_mean, self.rgb_std)
        _, endpoints = self.backbone(x.permute(0, 3, 1, 2), train,
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
                getattr(self, f"query_embed_{name}"))     # (B, S, C)
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
            out.append(head(glob) if self.single_head
                       else head(glob, max_indices))
        return {"pose": torch.cat(out, dim=-1),
                "scene_log_distr": scene_log_distr,
                "max_indices": max_indices}


def ems_pose_to_matrix(pose7: torch.Tensor, dataset_type: str = "7Scenes",
                       pose_avg_inv: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """EMSTransPoseNet's output head (transposenet.py:241-263): (B, 7) ->
    (B, 3, 4), R from the quaternion. Cambridge: R transposed, then
    _cambridge_to_opengl with pose_avg_inv, the inverse of the scene's
    homogeneous pose_avg_stats (pose_avg_inverse; the identity for None)."""
    R = quat_to_rotmat(pose7[:, 3:])
    if dataset_type != "Cambridge":
        return torch.cat([R, pose7[:, :3, None]], dim=-1)
    out = torch.cat([R.transpose(1, 2), pose7[:, :3, None]], dim=-1)
    if pose_avg_inv is None:
        pose_avg_inv = torch.eye(4, dtype=pose7.dtype, device=pose7.device)
    return _cambridge_to_opengl(out, pose_avg_inv)


def _cambridge_to_opengl(pose: torch.Tensor,
                         pose_avg_inv: torch.Tensor) -> torch.Tensor:
    """geometry.transforms.fix_coord_cambridge's centre-and-rotate step on
    the network's (B, 3, 4) outputs (transposenet.py:203-233): centred =
    pose_avg⁻¹ · pose, rotated 180° about x, R -> -R·diag(-1, 1, 1)."""
    c = (pose_avg_inv.to(pose.dtype) @ to_homogeneous(pose))[:, :3]
    p = torch.cat([c[:, :1], -c[:, 1:]], dim=1)          # rot180x
    R = torch.cat([p[:, :, :1], -p[:, :, 1:3]], dim=-1)  # -R·diag(-1, 1, 1)
    return torch.cat([R, p[:, :, 3:4]], dim=-1)
