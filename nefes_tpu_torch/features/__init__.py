from nefes_tpu_torch.features.dfnet import (  # noqa: F401
    DFNet, AdaptBlock, extract_target_features,
)
