from nefes_tpu_torch.features.dfnet import (  # noqa: F401
    DFNet, AdaptBlock, extract_target_features,
)
from nefes_tpu_torch.features.posenet import (  # noqa: F401
    EfficientNetB3APR, EfficientNetB3Feat, MapNet, PoseNetMapNetStyle,
    PoseNetRes34, PoseNetV2, PoseNetV2Feat, mapnet_output_to_pose12, qexp,
)
from nefes_tpu_torch.features.mstransformer import (  # noqa: F401
    MSTransPoseNet, ems_pose_to_matrix, pose_avg_inverse,
)
from nefes_tpu_torch.features.apr_loader import (  # noqa: F401
    APR_KINDS, load_apr,
)
