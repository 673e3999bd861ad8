from nefes_tpu_torch.data.scene import SceneData  # noqa: F401
from nefes_tpu_torch.data.synthetic import (  # noqa: F401
    look_at_pose, make_synthetic_scene, render_gt_features,
)
