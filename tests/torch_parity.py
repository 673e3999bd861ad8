"""Shared set-up of the port's parity tests: one model configuration for
both packages, the JAX model's random weights carried into the port, and
numpy <-> torch helpers. Everything runs on the CPU in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nefes_tpu.fields.embedder import EmbedConfig as JEmbed
from nefes_tpu.train.model import ModelConfig as JConfig
from nefes_tpu.train.model import NeFeSModel as JModel
from nefes_tpu_torch.fields.embedder import EmbedConfig as TEmbed
from nefes_tpu_torch.train.model import ModelConfig as TConfig
from nefes_tpu_torch.train.model import NeFeSModel as TModel
from nefes_tpu_torch.weights import from_jax_variables


def configs(**kw):
    """(JAX ModelConfig, port ModelConfig) with the same fields, f32;
    xyz_freqs / dir_freqs set the embeddings."""
    xf, df = kw.pop("xyz_freqs", 4), kw.pop("dir_freqs", 2)
    base = dict(depth=2, width=32, feature_dim=8, skips=(1,))
    base.update(kw)
    jcfg = JConfig(xyz_embed=JEmbed(num_freqs=xf),
                   dir_embed=JEmbed(num_freqs=df), dtype=jnp.float32, **base)
    tcfg = TConfig(xyz_embed=TEmbed(num_freqs=xf),
                   dir_embed=TEmbed(num_freqs=df), dtype=torch.float32,
                   **base)
    return jcfg, tcfg


def models(jcfg, tcfg, seed=0):
    """(JAX model, its variables, port model on the CPU holding the same
    weights)."""
    jmodel = JModel(jcfg)
    variables = jmodel.init_variables(jax.random.key(seed))
    tmodel = TModel(tcfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables), tcfg))
    return jmodel, variables, tmodel


def t(x, requires_grad=False):
    out = torch.from_numpy(np.array(x, dtype=np.float32))
    return out.requires_grad_(requires_grad)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def grads_by_name(jgrads: dict, variables, tcfg) -> dict:
    """JAX gradients w.r.t. (a sub-tree of) variables["params"] -> {the
    port's parameter name: numpy array}, mapped through the same
    from_jax_variables that carries the weights across; parameters
    outside the sub-tree get zeros."""
    params = jax.tree.map(np.zeros_like,
                          jax.tree.map(np.asarray, variables["params"]))
    params.update(jax.tree.map(np.asarray, jgrads))
    tree = {"params": params}
    if "batch_stats" in variables:
        tree["batch_stats"] = jax.tree.map(np.asarray,
                                           variables["batch_stats"])
    sd = from_jax_variables(tree, tcfg)
    return {k: v.numpy() for k, v in sd.items()
            if "running_" not in k and "num_batches" not in k}
