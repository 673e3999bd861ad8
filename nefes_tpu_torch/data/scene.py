"""SceneData, the dataset interface of training and refinement: one split
of one scene as whole numpy arrays; port of nefes_tpu/data/scene.py."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nefes_tpu_torch.data.histograms import luminance_histogram
from nefes_tpu_torch.geometry.transforms import WorldSetup


@dataclass
class SceneData:
    """One split (train or test) of one scene."""

    images: np.ndarray | None      # (N, H, W, 3) float32 [0, 1]
    poses: np.ndarray              # (N, 3, 4) c2w in the field's frame
    hists: np.ndarray | None       # (N, hist_bin) luminance histograms
    hwf: tuple[int, int, float]    # (H, W, focal)
    near: float
    far: float
    world: WorldSetup
    masks: np.ndarray | None = None      # (N, Hm, Wm) static masks
    image_paths: list = field(default_factory=list)
    raw_poses: np.ndarray | None = None  # dataset-frame poses
    depths: np.ndarray | None = None     # (N, H, W) mono-depth targets
    pose_avg_stats: np.ndarray | None = None  # (3, 4) centering pose

    def __len__(self) -> int:
        return len(self.poses)

    @property
    def H(self) -> int:
        return self.hwf[0]

    @property
    def W(self) -> int:
        return self.hwf[1]

    @property
    def focal(self) -> float:
        return self.hwf[2]


def compute_histograms(images: np.ndarray, bins: int = 10) -> np.ndarray:
    return np.stack([luminance_histogram(img, bins) for img in images])
