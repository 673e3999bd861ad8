"""The image losses mode-2 refinement records; the part of
nefes_tpu/train/losses.py the port needs so far."""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-10·log10(MSE) (reference img2mse / mse2psnr)."""
    return -10.0 * torch.log10(mse(pred, target))
