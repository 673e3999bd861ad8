from nefes_tpu_torch.parallel.mesh import (
    Mesh, init_distributed, make_mesh, replicated, batch_sharding,
    batch_ray_sharding, shard_batch, replicate, frame_sharding,
    gather_frames,
)
from nefes_tpu_torch.parallel.train_dp import (
    make_sharded_train_step, render_rays_sharded,
    refine_apr_sharded, refine_poses_sharded,
)
