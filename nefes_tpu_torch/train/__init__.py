"""The model bundle and field training (stages 0/1/2): ModelConfig,
NeFeSModel, the steps, the schedule, the optimizer, the losses and the
checkpoints."""

from nefes_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from nefes_tpu_torch.train.losses import (  # noqa: F401
    nefes_training_loss, psnr,
)
from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel  # noqa: F401
from nefes_tpu_torch.train.trainer import (  # noqa: F401
    AuxConfig, TrainState, create_train_state, lr_for_epoch, make_optimizer,
    patch_loss, rays_loss, stage_for_epoch, train_step_patch,
    train_step_rays,
)
