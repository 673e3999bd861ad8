"""NeRF frequency (positional) encoding and the Nerfies coarse-to-fine
window; port of nefes_tpu/fields/embedder.py. The channel order is the
reference interleave [x, sin(f0·x), cos(f0·x), sin(f1·x), ...], so
converted checkpoints hit the same input rows. Autograd differentiates
it, the window included."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class EmbedConfig:
    num_freqs: int = 10          # 10 for xyz, 4 for viewdirs
    max_freq_log2: float | None = None  # default num_freqs - 1
    include_input: bool = True
    log_sampling: bool = True
    input_dims: int = 3

    @property
    def freq_bands(self) -> np.ndarray:
        if self.num_freqs == 0:
            return np.zeros((0,), np.float32)
        mf = (self.max_freq_log2 if self.max_freq_log2 is not None
              else self.num_freqs - 1)
        if self.log_sampling:
            return (2.0 ** np.linspace(0.0, mf, self.num_freqs)).astype(
                np.float32)
        return np.linspace(2.0 ** 0.0, 2.0 ** mf,
                           self.num_freqs).astype(np.float32)

    @property
    def out_dim(self) -> int:
        d = self.input_dims if self.include_input else 0
        return d + 2 * self.num_freqs * self.input_dims


@functools.lru_cache(maxsize=None)
def _freqs(cfg: EmbedConfig, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """cfg's frequency bands on `device`, copied there once (a copy from
    the host cannot be captured in a CUDA graph; the first, uncaptured
    call fills the cache)."""
    return torch.as_tensor(cfg.freq_bands, dtype=dtype, device=device)


def embed(x: torch.Tensor, cfg: EmbedConfig,
          window: torch.Tensor | None = None) -> torch.Tensor:
    """Frequency-encode (..., D) -> (..., out_dim). window: optional
    (num_freqs,) coarse-to-fine weights on each band's sin and cos
    (Nerfies Eq. 8, reference embed_DNeRF nerfh_nff.py:282-297); None is
    all ones."""
    if cfg.num_freqs == 0:
        return x
    freqs = _freqs(cfg, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]                     # (..., F, D)
    s, c = torch.sin(xf), torch.cos(xf)
    if window is not None:
        w = window.to(x.dtype)[:, None]
        s, c = s * w, c * w
    flat = torch.stack([s, c], dim=-2).reshape(
        *x.shape[:-1], 2 * cfg.num_freqs * cfg.input_dims)
    if cfg.include_input:
        return torch.cat([x, flat], dim=-1)
    return flat


def cosine_window(num_freqs: int, epoch: float, epochs_to_full: float,
                  device=None) -> torch.Tensor:
    """Nerfies Eq. 8 coarse-to-fine band weights (reference
    get_embed_weight, nerfh_nff.py:272-280), (num_freqs,) f32."""
    alpha = num_freqs * epoch / epochs_to_full
    bands = torch.arange(num_freqs, dtype=torch.float32, device=device)
    t = torch.clamp(alpha - bands, 0.0, 1.0)
    return (1.0 - torch.cos(torch.pi * t)) * 0.5


def train_windows(epoch: float, xyz_cfg: EmbedConfig, dir_cfg: EmbedConfig,
                  epochs_to_full: float, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xyz_window, dir_window) of reduce_embedding=2 at an epoch (the
    reference re-reads render_kwargs['i_epoch'] every epoch,
    run_nefes.py:370-371)."""
    return (cosine_window(xyz_cfg.num_freqs, epoch, epochs_to_full, device),
            cosine_window(dir_cfg.num_freqs, epoch, epochs_to_full, device))
