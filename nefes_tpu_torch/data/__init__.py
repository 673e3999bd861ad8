from nefes_tpu_torch.data.scene import SceneData  # noqa: F401
from nefes_tpu_torch.data.synthetic import (  # noqa: F401
    look_at_pose, make_synthetic_scene, render_gt_features,
)
from nefes_tpu_torch.data.seven_scenes import (  # noqa: F401
    load_7scenes_colmap, load_7scenes_dslam, quat_poses_to_w2c,
)
from nefes_tpu_torch.data.cambridge import (  # noqa: F401
    load_cambridge, load_semantic_mask,
)
