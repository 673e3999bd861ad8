"""Training checkpoints over torch.save; port of
nefes_tpu/train/checkpoint.py (reference run_nefes.py:375-385).

A checkpoint holds the full train state, as the JAX package's does: the
model's state dict (parameters and FusionNet's running statistics), the
optimizer's moments and step count, and the epoch, so that a resumed run
takes the same next step. One file per save, epoch_<epoch>.pt. This
format only: it cannot read the JAX package's orbax checkpoints (convert
those with weights.from_jax_variables).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from nefes_tpu_torch.train.trainer import TrainState


def save_checkpoint(ckpt_dir: str | Path, state: TrainState,
                    epoch: int) -> str:
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"epoch_{epoch:06d}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.tx.state_dict(),
                "epoch": int(state.epoch)}, tmp)
    os.replace(tmp, path)     # a reader never sees a half-written file
    return str(path)


def latest_checkpoint(ckpt_dir: str | Path) -> str | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    cands = sorted(p for p in ckpt_dir.iterdir()
                   if p.name.startswith("epoch_") and p.suffix == ".pt")
    return str(cands[-1]) if cands else None


def restore_checkpoint(path: str | Path, template: TrainState) -> TrainState:
    """Load a checkpoint into `template` (same model configuration and
    device) and return it. Loads tensors only (weights_only)."""
    dev = next(template.model.parameters()).device
    ckpt = torch.load(Path(path), map_location=dev, weights_only=True)
    template.model.load_state_dict(ckpt["model"])
    template.tx.load_state_dict(ckpt["optimizer"])
    template.epoch = int(ckpt["epoch"])
    return template
