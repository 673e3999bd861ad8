from nefes_tpu_torch.refine.losses import (  # noqa: F401
    feature_cosine_loss, masked_feature_cosine_loss,
)
from nefes_tpu_torch.refine.pose_opt import (  # noqa: F401
    RefineConfig, refine_pose_captured, refine_pose_indexed,
    refine_pose_single, refine_poses_batch, refine_poses_scanned,
    render_feature_image,
)
from nefes_tpu_torch.refine.apr_opt import (  # noqa: F401
    apply_verification, apr_pose, apr_pose_any, apr_poses_batched,
    refine_apr_batch,
    refine_apr_captured, refine_apr_single, refine_apr_verified,
    refine_apr_verified_scanned,
)
