"""The scene and model builders of the training and refinement CLIs; port
of the builders of nefes_tpu/cli/train.py. The training CLI's main is not
ported yet (ROADMAP Queue A item 5); the refinement CLI uses these."""

from __future__ import annotations

import os

import torch

from nefes_tpu_torch.data import (
    load_7scenes_colmap, load_7scenes_dslam, load_cambridge,
)
from nefes_tpu_torch.fields.embedder import EmbedConfig
from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel


def build_scene(opts, train: bool, pose_avg_override=None):
    """The split of opts.datadir's scene (dataset_type 7Scenes_colmap,
    7Scenes or Cambridge)."""
    scene = os.path.basename(opts.datadir.rstrip("/"))
    root = os.path.dirname(opts.datadir.rstrip("/"))
    common = dict(train=train, trainskip=opts.trainskip,
                  testskip=opts.testskip, df=opts.df, hist_bin=opts.hist_bin,
                  load_pose_avg_stats=opts.load_pose_avg_stats,
                  pose_avg_override=pose_avg_override)
    if opts.dataset_type == "7Scenes_colmap":
        return load_7scenes_colmap(scene, root, opts.data_root, **common)
    if opts.dataset_type == "7Scenes":
        return load_7scenes_dslam(scene, root, opts.data_root, **common)
    if opts.dataset_type == "Cambridge":
        return load_cambridge(scene, root, semantic=opts.semantic,
                              tinyscale=opts.tinyscale, **common)
    raise ValueError(f"unknown dataset_type {opts.dataset_type!r}")


def embed_configs(opts) -> tuple[EmbedConfig, EmbedConfig]:
    """(xyz, dir) embeddings of reduce_embedding: 0 halves the frequency
    bands, 1 is the identity; otherwise multires / multires_views bands
    (2, the Nerfies window, anneals them in training only)."""
    if opts.reduce_embedding == 0:
        return tuple(EmbedConfig(num_freqs=m // 2, max_freq_log2=(m - 1) // 2)
                     for m in (opts.multires, opts.multires_views))
    if opts.reduce_embedding == 1:
        ident = EmbedConfig(num_freqs=0, max_freq_log2=0)
        return ident, ident
    return (EmbedConfig(num_freqs=opts.multires),
            EmbedConfig(num_freqs=opts.multires_views))


def is_zoo_field(opts) -> bool:
    """True when the flags select a field other than NeRFH-NFF (reference
    create_nerf's dispatch, models/options.py:43-48, nerfh.py:539-552)."""
    return (opts.tcnn or opts.sh_nff or opts.ffmlp
            or not opts.nerfh_nff or not opts.NeRFW)


def build_model(opts, dtype: torch.dtype = torch.float32, device="cuda",
                generator: torch.Generator | None = None):
    """(ModelConfig, NeFeSModel on device) of the flags; the model's
    weights are random (from `generator` where given) until loaded."""
    if is_zoo_field(opts):
        raise NotImplementedError(
            "the field zoo (tcnn, sh_nff, ffmlp, NeRF-W off, plain NeRF) is "
            "not ported: ROADMAP Queue A item 11")
    xyz, dirs = embed_configs(opts)
    cfg = ModelConfig(depth=opts.netdepth, width=opts.netwidth,
                      feature_dim=opts.feature_dim,
                      fusion_residual=opts.use_fusion_res,
                      fusion_no_bn=opts.no_fusion_BN,
                      hist_bin=opts.hist_bin, encode_hist=opts.encode_hist,
                      xyz_embed=xyz, dir_embed=dirs, dtype=dtype)
    return cfg, NeFeSModel(cfg, device=device, generator=generator)
