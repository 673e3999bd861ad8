from nefes_tpu_torch.utils.image import (  # noqa: F401
    resize_bicubic, resize_bilinear,
)
from nefes_tpu_torch.utils.ssim import ssim  # noqa: F401
