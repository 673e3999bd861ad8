"""The reference APR zoo's torch checkpoints -> the port's state dicts;
port of nefes_tpu/features/convert_backbones.py (the artifacts the
reference loads, script/dm/direct_pose_model.py:109-173):

  * torchvision resnet34 / mobilenet_v2 and lukemelas EfficientNet B0/B3
  * the reference APR heads: PoseNet_res34 (feature_extractor.*),
    PoseNetV2 / EfficientNetB3 (backbone_net.*), MapNet (mapnet.*)
    (script/dm/pose_model.py:226-333)
  * the official EMSTransPoseNet (script/mstransformer/transposenet.py)

Both sides are PyTorch, so a tensor keeps its layout and only its name
changes (the port's modules carry the JAX package's names), except in
the EMS checkpoint: nn.MultiheadAttention's packed in_proj splits into
query / key / value, the one shared position embedding
(backbone.1.{row,col}_embed) is copied into both branches, and the
per-scene heads regressor_head_{t,rot}.{s}.* are stacked, kernels (in,
out). Every BatchNorm's batch count is reset to 0. Inputs are the
{key: tensor} dicts of features.convert.load_torch_state_dict.
"""

from __future__ import annotations

import torch

_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _move(sd: dict, src: str, dst: str, out: dict) -> None:
    """src's weight / bias / running statistics -> dst's, f32."""
    for leaf in _LEAVES:
        if f"{src}.{leaf}" in sd:
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"].to(
                torch.float32).contiguous()
    if f"{src}.running_mean" in sd:
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# --- torchvision ResNet-34 (backbones.ResNet34) ---

def convert_resnet34(sd: dict, prefix: str = "") -> dict:
    """torchvision resnet34 keys (conv1, bn1, layer{1-4}.{i}.*) -> ResNet34's
    under prefix; the torch fc is left out (each APR has its own)."""
    out: dict = {}
    _move(sd, "conv1", f"{prefix}conv1", out)
    _move(sd, "bn1", f"{prefix}bn1", out)
    for stage, n in enumerate((3, 4, 6, 3)):
        for i in range(n):
            src, dst = f"layer{stage + 1}.{i}", f"{prefix}layer{stage + 1}_{i}"
            for name in ("conv1", "bn1", "conv2", "bn2"):
                _move(sd, f"{src}.{name}", f"{dst}.{name}", out)
            _move(sd, f"{src}.downsample.0", f"{dst}.downsample_conv", out)
            _move(sd, f"{src}.downsample.1", f"{dst}.downsample_bn", out)
    return out


def convert_posenet_res34(sd: dict) -> dict:
    """The reference PoseNet_res34 (pose_model.py:263-294):
    feature_extractor.* (torchvision resnet34 with fc -> 2048) + fc_pose
    -> PoseNetRes34."""
    bb = _sub(sd, "feature_extractor.")
    out = convert_resnet34(bb, "backbone.")
    _move(bb, "fc", "fc", out)
    _move(sd, "fc_pose", "fc_pose", out)
    return out


def convert_mapnet(sd: dict) -> dict:
    """The reference MapNet(PoseNet) (pose_model.py:297-380):
    [mapnet.]feature_extractor.* + [mapnet.]{fc_xyz, fc_wpqr} -> MapNet."""
    inner = (_sub(sd, "mapnet.") if any(k.startswith("mapnet.") for k in sd)
             else sd)
    bb = _sub(inner, "feature_extractor.")
    out = convert_resnet34(bb, "mapnet.backbone.")
    _move(bb, "fc", "mapnet.fc", out)
    for name in ("fc_xyz", "fc_wpqr"):
        _move(inner, name, f"mapnet.{name}", out)
    return out


# --- torchvision MobileNetV2 (backbones.MobileNetV2) ---

def convert_mobilenet_v2(sd: dict, prefix: str = "") -> dict:
    """torchvision mobilenet_v2 features.* -> MobileNetV2's under prefix.
    Block i is features.{i+1}; the expand-1 block's conv Sequential has
    three entries, the others four."""
    out: dict = {}
    _move(sd, "features.0.0", f"{prefix}stem.conv", out)
    _move(sd, "features.0.1", f"{prefix}stem.bn", out)
    for b in range(17):
        src, dst = f"features.{b + 1}.conv", f"{prefix}block_{b}"
        convs = ["depthwise"]
        if f"{src}.1.0.weight" in sd:
            convs = ["expand", "depthwise"]
        for j, name in enumerate(convs):
            _move(sd, f"{src}.{j}.0", f"{dst}.{name}.conv", out)
            _move(sd, f"{src}.{j}.1", f"{dst}.{name}.bn", out)
        _move(sd, f"{src}.{len(convs)}", f"{dst}.project.conv", out)
        _move(sd, f"{src}.{len(convs) + 1}", f"{dst}.project.bn", out)
    _move(sd, "features.18.0", f"{prefix}head.conv", out)
    _move(sd, "features.18.1", f"{prefix}head.bn", out)
    return out


def convert_posenet_v2(sd: dict) -> dict:
    """The reference PoseNetV2 (pose_model.py:247-260): backbone_net.* +
    fc_pose -> PoseNetV2."""
    out = convert_mobilenet_v2(_sub(sd, "backbone_net."), "backbone.")
    _move(sd, "fc_pose", "fc_pose", out)
    return out


# --- lukemelas EfficientNet B0/B3 (backbones.EfficientNet) ---

_MBCONV = (("_expand_conv", "expand_conv"), ("_bn0", "bn0"),
           ("_depthwise_conv", "depthwise_conv"), ("_bn1", "bn1"),
           ("_se_reduce", "se_reduce"), ("_se_expand", "se_expand"),
           ("_project_conv", "project_conv"), ("_bn2", "bn2"))


def convert_efficientnet(sd: dict, prefix: str = "") -> dict:
    """lukemelas EfficientNet keys (_conv_stem, _bn0, _blocks.{i}.*,
    _conv_head, _bn1) -> EfficientNet's under prefix."""
    out: dict = {}
    _move(sd, "_conv_stem", f"{prefix}stem_conv", out)
    _move(sd, "_bn0", f"{prefix}stem_bn", out)
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("_blocks.")})
    for i in range(n_blocks):
        for src, dst in _MBCONV:
            _move(sd, f"_blocks.{i}.{src}", f"{prefix}block_{i}.{dst}", out)
    _move(sd, "_conv_head", f"{prefix}head_conv", out)
    _move(sd, "_bn1", f"{prefix}head_bn", out)
    return out


def convert_efficientnet_b3_apr(sd: dict) -> dict:
    """The reference EfficientNetB3 (pose_model.py:226-244):
    backbone_net.* (lukemelas) + fc_pose -> EfficientNetB3APR."""
    out = convert_efficientnet(_sub(sd, "backbone_net."), "backbone.")
    _move(sd, "fc_pose", "fc_pose", out)
    return out


# --- the official EMSTransPoseNet (mstransformer.MSTransPoseNet) ---

def _mha(sd: dict, src: str, dst: str, out: dict) -> None:
    """nn.MultiheadAttention (packed in_proj) -> MHA's query / key / value
    / out Linears."""
    w, b = sd[f"{src}.in_proj_weight"], sd[f"{src}.in_proj_bias"]
    d = w.shape[1]
    for i, name in enumerate(("query", "key", "value")):
        out[f"{dst}.attn.{name}.weight"] = w[i * d:(i + 1) * d].to(
            torch.float32).contiguous()
        out[f"{dst}.attn.{name}.bias"] = b[i * d:(i + 1) * d].to(
            torch.float32).contiguous()
    _move(sd, f"{src}.out_proj", f"{dst}.attn.out", out)


def _branch(sd: dict, src: str, dst: str, layers: int, out: dict) -> None:
    """The reference Transformer (transformer.py) -> TransformerBranch."""
    for part, tag, norms in (("encoder", "enc", 2), ("decoder", "dec", 3)):
        for i in range(layers):
            s, t = f"{src}.{part}.layers.{i}", f"{dst}.{tag}_{i}"
            _mha(sd, f"{s}.self_attn", f"{t}.self_attn", out)
            if part == "decoder":
                _mha(sd, f"{s}.multihead_attn", f"{t}.cross_attn", out)
            for name in ("linear1", "linear2", *(f"norm{k + 1}"
                                                  for k in range(norms))):
                _move(sd, f"{s}.{name}", f"{t}.{name}", out)
        _move(sd, f"{src}.{part}.norm", f"{dst}.{tag}_norm", out)


def convert_mstransformer(sd: dict, num_scenes: int = 7, layers: int = 6,
                          single_head: bool = False) -> dict:
    """The official EMSTransPoseNet state dict -> MSTransPoseNet's:
    backbone.0.body.* (lukemelas B0), backbone.1.{row,col}_embed (shared,
    copied into pos_embed_t and pos_embed_rot), transformer_{t,rot}.*,
    input_proj_{t,rot}, query_embed_{t,rot}, scene_embed,
    regressor_head_{t,rot}[.{s}].{fc_h,fc_o} (stacked per scene unless
    single_head)."""
    out = convert_efficientnet(_sub(sd, "backbone.0.body."), "backbone.")

    def f32(key):
        return sd[key].to(torch.float32)
    for name in ("t", "rot"):
        for emb in ("row_embed", "col_embed"):
            out[f"pos_embed_{name}.{emb}"] = f32(
                f"backbone.1.{emb}.weight").clone()
        _move(sd, f"input_proj_{name}", f"input_proj_{name}", out)
        out[f"query_embed_{name}"] = f32(f"query_embed_{name}.weight")
        _branch(sd, f"transformer_{name}", f"transformer_{name}", layers,
                out)
        head = f"regressor_head_{name}"
        if single_head:
            for fc in ("fc_h", "fc_o"):
                _move(sd, f"{head}.{fc}", f"{head}.{fc}", out)
            continue
        for fc in ("fc_h", "fc_o"):
            out[f"{head}.{fc}_kernel"] = torch.stack([
                f32(f"{head}.{s}.{fc}.weight").t()
                for s in range(num_scenes)]).contiguous()
            out[f"{head}.{fc}_bias"] = torch.stack([
                f32(f"{head}.{s}.{fc}.bias") for s in range(num_scenes)])
    _move(sd, "scene_embed", "scene_embed", out)
    return out
