"""Options: one dataclass of the training and refinement flags, and a
reader of the reference's per-scene key = value config txts; port of
nefes_tpu/cli/options.py. The fields and their defaults are the JAX
package's, plus `device` ("cuda" unless the caller asks for "cpu")."""

from __future__ import annotations

import argparse
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any


@dataclass
class Options:
    """The reference's training (models/options.py) and refinement
    (dm/options.py) flags that this framework models; defaults as the
    reference's."""

    # experiment / paths
    config: str | None = None
    expname: str = "exp"
    basedir: str = "logs"
    datadir: str = "data/deepslam_data/7Scenes/chess"
    dataset_type: str = "7Scenes_colmap"   # 7Scenes | 7Scenes_colmap | Cambridge
    data_root: str = "data"                # root holding world_setup dirs

    # data loading
    trainskip: int = 1
    testskip: int = 1
    df: float = 2.0
    load_pose_avg_stats: bool = True
    semantic: bool = False

    # field architecture (options.py:30-48)
    netdepth: int = 8
    netwidth: int = 128
    feature_dim: int = 128
    use_fusion_res: bool = False
    no_fusion_BN: bool = False

    # field selection (options.py:43-48): nerfh_nff is the paper's field;
    # tcnn / sh_nff / ffmlp / NeRFW=False select the zoo fields
    nerfh_nff: bool = True
    ffmlp: bool = False
    tcnn: bool = False
    sh_nff: bool = False
    N_vocab: int = 1000
    hash_level: int = 16
    bound: float = 25.0

    # embedding
    multires: int = 10
    multires_views: int = 4
    reduce_embedding: int = -1
    epochToMaxFreq: int = -1

    # rendering (options.py:94-106)
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    use_fine_only: bool = False
    tinyscale: float = 4.0

    # NeRF-W (options.py:65-84)
    NeRFW: bool = True
    encode_hist: bool = True
    hist_bin: int = 10
    transient_at_test: bool = False

    # training (options.py:33-40,123)
    N_rand: int = 1536
    remat: str = "auto"
    lrate: float = 5e-4
    lrate_decay: float = 0.754
    grad_clip: float = 0.0
    batch_size: int = 4
    epochs: int = 600
    new_schedule: int = 1
    i_weights: int = 200
    i_testset: int = 200
    i_print: int = 10
    val_views: int = 8
    no_reload: bool = False
    ft_path: str | None = None
    set_near_far: bool = False
    near_far: tuple = (0.5, 2.5)

    # losses (options.py:74-77)
    color_loss_only: bool = False
    color_feat_loss: bool = False
    color_feat_fusion_loss: bool = False
    color_feat_fusion_nerfw_loss: bool = False

    # auxiliary regularizers (options.py:52-55,61,78-79)
    tvloss: bool = False
    tvloss_w: float = 1e-6
    l1normloss: bool = False
    l1normloss_w: float = 1e-6
    sigma_sparsity_loss: bool = False
    sigma_sparsity_loss2: bool = False
    depth_loss: bool = False

    # APR / refinement (dm/options.py)
    pose_only: int = 0
    learning_rate: float = 1e-5
    PoseEstimatorType: str = "DFNet"
    pretrain_model_path: str = ""
    pretrain_featurenet_path: str = ""
    lr_r: float = 0.01
    lr_t: float = 0.1
    opt_iter: int = 50
    # frames refined together (refine_poses_batch / refine_apr_batch)
    refine_batch: int = 1
    # frames folded into one call (the *_scanned functions), at
    # refine_batch 1
    scan_frames: int = 1
    # the APR's compute dtype in refinement (the reference pins float32)
    apr_compute_dtype: str = "float32"
    # the field's compute dtype in refinement (parameters stay f32)
    field_compute_dtype: str = "bfloat16"
    no_verification_step: bool = False
    # the verification fail-safe's retreat signal: "psnr_ssim" (the
    # reference's), "dfm" (the feature loss rose) or "either"
    verification_metric: str = "psnr_ssim"
    # FusionNet's BN statistics in refinement: "batch" (the reference's),
    # "running" or "none" (no fusion)
    fusion_bn: str = "batch"
    per_pixel: bool = False
    svd_reg: bool = False
    freezeBN: bool = False
    feature_matching_lvl: tuple = (0,)

    # the refined-pose txt's directory; empty: tmp/<APR>_NeFeS<iters>_
    # <dataset>/<scene>/ (the reference's test_refinement.py layout)
    save_dir: str = ""

    # eval / render
    render_test: bool = False
    render_video_train: bool = False
    render_video_test: bool = False
    render_pose_only: bool = False
    spiral_views: int = 120

    profile_dir: str = ""

    # the port's entry points run on the card unless "cpu" is asked for
    device: str = "cuda"

    def render_hw(self, H: int, W: int) -> tuple[int, int]:
        return int(H // self.tinyscale), int(W // self.tinyscale)


_BOOL_TRUE = {"true", "1", "yes"}
_BOOL_FALSE = {"false", "0", "no"}


def _parse_value(raw: str, current: Any) -> Any:
    raw = raw.strip()
    if isinstance(current, bool):
        low = raw.lower()
        if low in _BOOL_TRUE:
            return True
        if low in _BOOL_FALSE:
            return False
        raise ValueError(f"bad bool {raw!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(float(raw))
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = raw.replace("[", "").replace("]", "").replace(",", " ").split()
        return tuple(type(current[0])(p) for p in parts) if current \
            else tuple(parts)
    if raw.lower() == "none":
        return None
    return raw


def read_config_file(path: str | Path) -> dict[str, str]:
    """A reference config txt (key = value lines, # comments)."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def load_options(config_path: str | Path | None = None,
                 overrides: dict | None = None) -> Options:
    """Options from defaults <- config file <- overrides; unknown keys
    (the reference's flags that are not modelled) are printed and
    ignored."""
    opts = Options()
    known = {f.name for f in fields(Options)}
    merged: dict[str, str | Any] = {}
    if config_path:
        merged.update(read_config_file(config_path))
    if overrides:
        merged.update(overrides)
    unknown = []
    for k, v in merged.items():
        if k not in known:
            unknown.append(k)
            continue
        cur = getattr(opts, k)
        setattr(opts, k, _parse_value(v, cur) if isinstance(v, str) else v)
    if unknown:
        print(f"[options] ignoring unknown keys: {sorted(unknown)}")
    return opts


def options_argparser() -> argparse.ArgumentParser:
    """Every Options field as --flag; only flags given override."""
    p = argparse.ArgumentParser()
    for f in fields(Options):
        p.add_argument(f"--{f.name}", default=None, type=str)
    return p


def options_from_cli(argv=None) -> Options:
    ns, unknown = options_argparser().parse_known_args(argv)
    if unknown:
        print(f"[options] ignoring unknown CLI args: {unknown}")
    overrides = {k: v for k, v in vars(ns).items() if v is not None}
    return load_options(overrides.pop("config", None), overrides)
