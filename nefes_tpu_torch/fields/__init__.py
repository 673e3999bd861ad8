from nefes_tpu_torch.fields.embedder import EmbedConfig, embed  # noqa: F401
from nefes_tpu_torch.fields.nerfh_nff import (  # noqa: F401
    ExposureMLP, FusionNet, NeRFHNFF, affine_color_transform,
)
from nefes_tpu_torch.fields.activation import (  # noqa: F401
    trunc_exp, trunc_softplus,
)
from nefes_tpu_torch.fields.decoder import GiraffeDecoder  # noqa: F401
from nefes_tpu_torch.fields.hashgrid import (  # noqa: F401
    HashGridEncoding, NeRFHTcnn, spherical_harmonics_deg4,
)
from nefes_tpu_torch.fields.legacy import NeRFW, PlainNeRF  # noqa: F401
