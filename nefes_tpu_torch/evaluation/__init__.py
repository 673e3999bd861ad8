from nefes_tpu_torch.evaluation.metrics import (  # noqa: F401
    ACCURACY_BUCKETS, accuracy_stats, load_pose_txt, pose_errors,
    rotation_angle_np, save_pose_txt, summarize,
)
from nefes_tpu_torch.evaluation.golden import (  # noqa: F401
    CAMBRIDGE_SCENES, SEVEN_SCENES, evaluate_all, evaluate_scene,
    paper_result_dir,
)
