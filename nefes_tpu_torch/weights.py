"""The JAX package's ``variables`` pytrees (as nested dicts of numpy
arrays) -> the state dicts of the port's NeFeSModel and DFNet.

  Dense kernel (in, out)            -> Linear weight (out, in)
  SplitDense kernel (da + db, out)  -> one Linear over the concat input
  Conv kernel HWIO                  -> Conv2d weight OIHW
  BatchNorm scale/bias, mean/var    -> weight/bias, running_mean/var

The port never sees JAX: callers convert with
``jax.tree.map(np.asarray, variables)`` first.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense_tree(prefix: str, tree: dict, out: dict) -> None:
    """Every {kernel (in, out), bias} leaf pair of a flax MLP."""
    for name, leaf in tree.items():
        out[f"{prefix}.{name}.weight"] = _t(leaf["kernel"]).t().contiguous()
        out[f"{prefix}.{name}.bias"] = _t(leaf["bias"])


def from_jax_variables(variables_np: dict, cfg) -> dict:
    """variables {params: {coarse, fine, exposure, fusion}[, batch_stats:
    {fusion}]} -> NeFeSModel(cfg).state_dict() layout."""
    params = variables_np["params"]
    out: dict[str, torch.Tensor] = {}
    for typ in ("coarse", "fine"):
        _dense_tree(typ, params[typ], out)
    _dense_tree("exposure", params["exposure"], out)
    fusion = params["fusion"]
    for name, leaf in fusion.items():
        if name == "bn":
            continue
        out[f"fusion.{name}.weight"] = _t(leaf["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        out[f"fusion.{name}.bias"] = _t(leaf["bias"])
    if not cfg.fusion_no_bn:
        stats = variables_np["batch_stats"]["fusion"]["bn"]
        out["fusion.bn.weight"] = _t(fusion["bn"]["scale"])
        out["fusion.bn.bias"] = _t(fusion["bn"]["bias"])
        out["fusion.bn.running_mean"] = _t(stats["mean"])
        out["fusion.bn.running_var"] = _t(stats["var"])
        out["fusion.bn.num_batches_tracked"] = torch.tensor(0)
    return out


def _conv(leaf: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
    out[f"{prefix}.bias"] = _t(leaf["bias"])


def dfnet_from_jax_variables(variables_np: dict) -> dict:
    """DFNet variables {params, batch_stats} -> the port's
    DFNet().state_dict() layout: the VGG16 convs and the AdaptBlock convs
    HWIO -> OIHW, fc_pose (in, out) -> (out, in), each AdaptBlock's BN
    scale/bias and mean/var."""
    params = variables_np["params"]
    stats = variables_np["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if name == "fc_pose":
            out["fc_pose.weight"] = _t(leaf["kernel"]).t().contiguous()
            out["fc_pose.bias"] = _t(leaf["bias"])
        elif name.startswith("adapt_"):
            _conv(leaf["conv1"], f"{name}.conv1", out)
            _conv(leaf["conv2"], f"{name}.conv2", out)
            bn = stats[name]["bn"]
            out[f"{name}.bn.weight"] = _t(leaf["bn"]["scale"])
            out[f"{name}.bn.bias"] = _t(leaf["bn"]["bias"])
            out[f"{name}.bn.running_mean"] = _t(bn["mean"])
            out[f"{name}.bn.running_var"] = _t(bn["var"])
            out[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
        else:
            _conv(leaf, name, out)
    return out
