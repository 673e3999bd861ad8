"""The reference's torch checkpoints -> the port's state dicts; port of
nefes_tpu/features/convert.py.

The reference (script/models/nerfh_nff.py, script/feature/dfnet.py) and
the port are both PyTorch, so a Linear stays (out, in) and a Conv2d OIHW:
only the names change, and the tiny-cuda-nn exposure MLP's packed buffer
is unpacked into three Linear layers.

  reference                                  port
  xyz_encoding_{i}.0 / dir_encoding.0 /      xyz_encoding_{i} / dir_encoding /
  static_{sigma,rgb}.0                       static_{sigma,rgb}
  transient_encoding.{0,2,4}                 transient_encoding_{1,2,3}
  transient_{sigma,rgb,beta}.0               transient_{sigma,rgb,beta}
  fusion_net.net.{0,2,4,6} / net.7           fusion.conv{0..3} / fusion.bn
  exposure_embedding.params                  exposure.hidden_{0..2} / out
  encoder.{0,2,...,28}                       conv1_1 ... conv5_3
  adaptation_layers.adapt_layer_{l}.{0,2,3}  adapt_{l}.conv1 / conv2 / bn
"""

from __future__ import annotations

import torch

# torchvision vgg16.features Conv2d indices -> the port's layer names
VGG16_TORCH_IDX = {
    0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}
_BN_NUM_BATCHES = "num_batches_tracked"


def load_torch_state_dict(path: str, prefix: str = ""
                          ) -> dict[str, torch.Tensor]:
    """A torch checkpoint as one flat {key: tensor} dict on the CPU: a raw
    state dict, {'state_dict': ...}, or the reference's .tar of state
    dicts ({'network_fn_state_dict': {...}} -> 'network_fn_state_dict.*').
    Tensors and containers only (weights_only)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
        elif isinstance(v, dict):
            for kk, vv in v.items():
                if isinstance(vv, torch.Tensor):
                    out[f"{k}.{kk}"] = vv.detach()
    if prefix:
        out = {k[len(prefix):]: v for k, v in out.items()
               if k.startswith(prefix)}
    return out


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _copy(sd: dict, src: str, dst: str, out: dict) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def _bn(sd: dict, src: str, dst: str, out: dict) -> None:
    _copy(sd, src, dst, out)
    out[f"{dst}.running_mean"] = _f32(sd[f"{src}.running_mean"])
    out[f"{dst}.running_var"] = _f32(sd[f"{src}.running_var"])
    out[f"{dst}.{_BN_NUM_BATCHES}"] = torch.tensor(0)


def convert_dfnet(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference DFNet's state dict -> the port's DFNet().state_dict()
    layout (running statistics kept, the batch count reset to 0)."""
    out: dict[str, torch.Tensor] = {}
    for idx, name in VGG16_TORCH_IDX.items():
        _copy(sd, f"encoder.{idx}", name, out)
    for lv in range(3):
        base = f"adaptation_layers.adapt_layer_{lv}"
        _copy(sd, f"{base}.0", f"adapt_{lv}.conv1", out)
        _copy(sd, f"{base}.2", f"adapt_{lv}.conv2", out)
        _bn(sd, f"{base}.3", f"adapt_{lv}.bn", out)
    if "fc_pose.weight" in sd:
        _copy(sd, "fc_pose", "fc_pose", out)
    return out


def convert_fusion_net(sd: dict[str, torch.Tensor],
                       prefix: str = "fusion_net.", no_bn: bool = False
                       ) -> dict[str, torch.Tensor]:
    """The reference FusionNet (nerfh_nff.py:356-394: convs at
    net.{0,2,4,6}, BN at net.7) -> FusionNet().state_dict() layout."""
    out: dict[str, torch.Tensor] = {}
    for i, t in enumerate((0, 2, 4, 6)):
        _copy(sd, f"{prefix}net.{t}", f"conv{i}", out)
    if not no_bn:
        _bn(sd, f"{prefix}net.7", "bn", out)
    return out


def convert_nerfh_nff(sd: dict[str, torch.Tensor], depth: int = 8,
                      transient: bool = False) -> dict[str, torch.Tensor]:
    """A reference NeRFH_NFF tower (nerfh_nff.py:469-505) ->
    NeRFHNFF().state_dict() layout."""
    out: dict[str, torch.Tensor] = {}
    for i in range(1, depth + 1):
        _copy(sd, f"xyz_encoding_{i}.0", f"xyz_encoding_{i}", out)
    _copy(sd, "xyz_encoding_final", "xyz_encoding_final", out)
    for name in ("dir_encoding", "static_sigma", "static_rgb"):
        _copy(sd, f"{name}.0", name, out)
    if transient:
        for j, t in enumerate((0, 2, 4)):
            _copy(sd, f"transient_encoding.{t}",
                  f"transient_encoding_{j + 1}", out)
        for name in ("transient_sigma", "transient_rgb", "transient_beta"):
            _copy(sd, f"{name}.0", name, out)
    return out


def convert_exposure_mlp(packed: torch.Tensor, n_input: int = 10,
                         n_hidden: int = 32, n_layers: int = 3,
                         n_output: int = 12) -> dict[str, torch.Tensor]:
    """Unpack a tiny-cuda-nn FullyFusedMLP parameter buffer
    (nerfh_nff.py:512-521) -> ExposureMLP().state_dict() layout.

    tcnn packs each layer row-major with widths padded to 16 and no
    biases: layer 0 (hidden, in_pad), the hidden layers (hidden, hidden),
    the output (out_pad, hidden). tcnn pads the input vector with ones, so
    layer 0's padded columns sum to its bias."""
    in_pad = -(-n_input // 16) * 16
    out_pad = -(-n_output // 16) * 16
    sizes = ([n_hidden * in_pad] + [n_hidden * n_hidden] * (n_layers - 1)
             + [out_pad * n_hidden])
    flat = _f32(packed).reshape(-1)
    if flat.numel() != sum(sizes):
        raise ValueError(f"exposure buffer of {flat.numel()} values, the "
                         f"layers need {sum(sizes)}")
    chunks = torch.split(flat, sizes)
    w0 = chunks[0].reshape(n_hidden, in_pad)
    bias = w0[:, n_input]
    for j in range(n_input + 1, in_pad):    # numpy's order: left to right
        bias = bias + w0[:, j]
    out = {"hidden_0.weight": w0[:, :n_input].contiguous(),
           "hidden_0.bias": bias}
    for i in range(1, n_layers):
        out[f"hidden_{i}.weight"] = chunks[i].reshape(n_hidden, n_hidden)
        out[f"hidden_{i}.bias"] = torch.zeros(n_hidden)
    out["out.weight"] = chunks[-1].reshape(out_pad, n_hidden)[
        :n_output].contiguous()
    out["out.bias"] = torch.zeros(n_output)
    return out


def convert_nefes_checkpoint(tar_path: str, depth: int = 8
                             ) -> dict[str, torch.Tensor]:
    """A reference NeFeS .tar (run_nefes.py:375-385) -> the state dict of
    the port's NeFeSModel: coarse, fine (with its transient heads),
    exposure and fusion, each where the checkpoint has it."""
    sd = load_torch_state_dict(tar_path)
    sub = {}
    for typ in ("network_fn_state_dict", "network_fine_state_dict"):
        p = typ + "."
        sub[typ] = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    coarse, fine = sub["network_fn_state_dict"], sub[
        "network_fine_state_dict"]
    parts = {"coarse": convert_nerfh_nff(coarse, depth, transient=False),
             "fine": convert_nerfh_nff(fine, depth, transient=True)}
    if "exposure_embedding.params" in coarse:
        parts["exposure"] = convert_exposure_mlp(
            coarse["exposure_embedding.params"])
    if any(k.startswith("fusion_net.") for k in coarse):
        parts["fusion"] = convert_fusion_net(coarse)
    return {f"{part}.{k}": v for part, tree in parts.items()
            for k, v in tree.items()}
