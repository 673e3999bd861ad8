"""APR loading and dispatch, the reference's load_APR_and_FeatureNet
(script/dm/direct_pose_model.py:109-173); port of
nefes_tpu/features/apr_loader.py.

load_apr builds the pose estimator of a kind, loads its reference
checkpoint when a path is given (seeded random weights otherwise), and
returns (module, pose_fn) with pose_fn(image (H, W, 3)) -> (3, 4), the
pose in the APR's own frame: callers apply svd_reg and fix_coord_supp as
the reference does.
"""

from __future__ import annotations

import torch

# the kinds load_apr builds ("PoseNet" is the reference's name for
# PoseNet_res34, load_PoseNet)
APR_KINDS = ("DFNet", "PoseNet", "PoseNetRes34", "PoseNetV2",
             "EfficientNetB3", "MapNet", "MsTransformer")


def load_apr(estimator_type: str, ckpt_path: str | None, image_hw: tuple,
             generator: torch.Generator, feature_dim: int = 128,
             dataset_type: str = "7Scenes", num_scenes: int = 7,
             pose_avg_stats=None, device="cuda"):
    """estimator_type: one of APR_KINDS (dm/options.py:130's choices and
    the zoo's families). image_hw is the queries' (H, W) (the JAX package
    initialises on it; the port's modules take any size). NetVlad (no
    model to load, direct_pose_model.py:166-168) and unknown kinds raise
    NotImplementedError. Returns (module, pose_fn)."""
    from nefes_tpu_torch.features import convert_backbones as cb
    from nefes_tpu_torch.features import posenet
    from nefes_tpu_torch.features.convert import (
        convert_dfnet, load_torch_state_dict,
    )
    from nefes_tpu_torch.features.dfnet import DFNet
    from nefes_tpu_torch.features.mstransformer import (
        MSTransPoseNet, ems_pose_to_matrix,
    )
    kw = dict(device=device, generator=generator)
    builders = {
        "DFNet": (lambda: DFNet(output_dim=feature_dim, **kw), convert_dfnet),
        "PoseNet": (lambda: posenet.PoseNetRes34(**kw),
                    cb.convert_posenet_res34),
        "PoseNetV2": (lambda: posenet.PoseNetV2(**kw), cb.convert_posenet_v2),
        "EfficientNetB3": (lambda: posenet.EfficientNetB3APR(**kw),
                           cb.convert_efficientnet_b3_apr),
        "MapNet": (lambda: posenet.MapNet(**kw), cb.convert_mapnet),
        "MsTransformer": (lambda: MSTransPoseNet(
            num_scenes=num_scenes, pose_avg_stats=pose_avg_stats, **kw),
            lambda sd: cb.convert_mstransformer(sd, num_scenes=num_scenes)),
    }
    builders["PoseNetRes34"] = builders["PoseNet"]
    if estimator_type not in builders:
        raise NotImplementedError(
            f"PoseEstimatorType {estimator_type!r} (NetVlad has no model to "
            "load, direct_pose_model.py:166-168)")
    build, convert = builders[estimator_type]
    module = build()
    if ckpt_path:
        module.load_state_dict(convert(load_torch_state_dict(ckpt_path)))

    def pose_fn(image: torch.Tensor) -> torch.Tensor:
        if estimator_type == "DFNet":
            return module(image[None], return_feature=False)[1].reshape(3, 4)
        if estimator_type == "MsTransformer":
            return ems_pose_to_matrix(module(image[None])["pose"],
                                      dataset_type, module.pose_avg_inv)[0]
        return module(image[None]).reshape(3, 4)

    return module, pose_fn
