"""NeRF frequency (positional) encoding; port of
nefes_tpu/fields/embedder.py. The channel order is the reference
interleave [x, sin(f0·x), cos(f0·x), sin(f1·x), ...], so converted
checkpoints hit the same input rows. Autograd differentiates it."""

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


def embed(x: torch.Tensor, cfg: EmbedConfig) -> torch.Tensor:
    """Frequency-encode (..., D) -> (..., out_dim)."""
    if cfg.num_freqs == 0:
        return x
    freqs = _freqs(cfg, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]                     # (..., F, D)
    flat = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(
        *x.shape[:-1], 2 * cfg.num_freqs * cfg.input_dims)
    if cfg.include_input:
        return torch.cat([x, flat], dim=-1)
    return flat
