"""The JAX package's ``variables`` pytrees (as nested dicts of numpy
arrays) -> the state dicts of the port's NeFeSModel, DFNet, the APR zoo
(apr_from_jax_variables) and the field zoo (zoo_from_jax_variables).

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


def apr_from_jax_variables(variables_np: dict) -> dict:
    """The variables {params[, batch_stats]} of an APR of the zoo
    (features/posenet.py, mstransformer.py) -> the port's state dict. The
    port's modules carry the flax names, so a leaf's path is its key:

      Conv kernel HWIO                    -> weight OIHW
      Dense kernel (in, out)              -> weight (out, in)
      attention query / key / value kernel (d, heads, hd), bias (heads,
        hd); out kernel (heads, hd, d)    -> Linear weight (d, d), bias
      LayerNorm / BatchNorm scale         -> weight
      BatchNorm mean / var                -> running_mean / running_var
      anything else (the stacked heads, embeddings, queries) as it is.
    """
    out: dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: str, stats: bool) -> None:
        for name, leaf in tree.items():
            key = f"{prefix}{name}"
            if isinstance(leaf, dict):
                walk(leaf, key + ".", stats)
                continue
            x = _t(leaf)
            parent = prefix.rstrip(".").rsplit(".", 1)[-1]
            if stats:
                out[f"{prefix}running_{name}"] = x
                out[f"{prefix}num_batches_tracked"] = torch.tensor(0)
            elif name == "kernel" and x.ndim == 4:
                out[f"{prefix}weight"] = x.permute(3, 2, 0, 1).contiguous()
            elif name == "kernel" and x.ndim == 3:        # attention
                x = x.reshape(-1, x.shape[-1]) if parent == "out" \
                    else x.reshape(x.shape[0], -1)
                out[f"{prefix}weight"] = x.t().contiguous()
            elif name == "kernel":
                out[f"{prefix}weight"] = x.t().contiguous()
            elif name == "scale":
                out[f"{prefix}weight"] = x
            elif name == "bias":
                out[key] = x.reshape(-1)
            else:
                out[key] = x

    walk(variables_np["params"], "", False)
    walk(variables_np.get("batch_stats", {}), "", True)
    return out


def zoo_from_jax_variables(variables_np: dict) -> dict:
    """The variables {params} of a field of the zoo (train/field_zoo.py
    ZooFieldModel, or one of its fields or fields/decoder.py
    GiraffeDecoder alone) -> the port's state dict. The modules carry the
    flax names, so apr_from_jax_variables' mapping applies: Dense kernel
    (in, out) -> Linear weight (out, in), Conv kernel HWIO -> OIHW, each
    hash level_<l> table and Embed table as it is."""
    return apr_from_jax_variables(variables_np)
