from nefes_tpu_torch.geometry.se3 import (  # noqa: F401
    compose_delta, learn_pose, orthogonalize_rotation, pack_se3,
    quat_to_rotmat, rotation_angle, rotmat_to_quat, se3_exp, skew, so3_exp,
    so3_left_jacobian, to_homogeneous,
)
from nefes_tpu_torch.geometry.transforms import (  # noqa: F401
    WorldSetup, fix_coord_supp,
)
from nefes_tpu_torch.geometry.rays import get_rays  # noqa: F401
