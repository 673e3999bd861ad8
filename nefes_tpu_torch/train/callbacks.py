"""Training callbacks: EarlyStopping (reference script/dm/callbacks.py:6);
port of nefes_tpu/train/callbacks.py.

A patience-based best-checkpoint saver, monitoring a loss or PSNR. The
caller provides ``save_fn(path, state)``, e.g. a wrapper of
train/checkpoint.py's save_checkpoint or torch.save."""

from __future__ import annotations

import os
from typing import Any, Callable


class EarlyStopping:
    """Stops training when the monitored metric stops improving.

    val_on_psnr=False: monitor a loss (lower better).
    val_on_psnr=True:  monitor PSNR (higher better).
    """

    def __init__(self, out_folder: str,
                 save_fn: Callable[[str, Any], None],
                 patience: int = 50, verbose: bool = False,
                 delta: float = 0.0, val_on_psnr: bool = False):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.val_on_psnr = val_on_psnr
        self.counter = 0
        self.best_score: float | None = None
        self.early_stop = False
        self.val_metric_min = float("inf")
        self.save_fn = save_fn
        self.out_folder = out_folder
        os.makedirs(out_folder, exist_ok=True)
        self.ckpt_save_path = os.path.join(out_folder, "checkpoint.pt")

    def __call__(self, val_loss: float, state, epoch: int = -1,
                 save_multiple: bool = False, save_all: bool = False,
                 val_psnr: float | None = None) -> None:
        metric = val_psnr if self.val_on_psnr else val_loss
        score = metric if self.val_on_psnr else -val_loss
        if self.best_score is None:
            self.best_score = score
            self.save_checkpoint(metric, state, epoch, save_multiple)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
            if save_all:
                self.save_checkpoint(metric, state, epoch,
                                     save_multiple=True, update_best=False)
        else:
            self.best_score = score
            self.save_checkpoint(metric, state, epoch, save_multiple)
            self.counter = 0

    def save_checkpoint(self, val_metric: float, state, epoch: int = -1,
                        save_multiple: bool = False,
                        update_best: bool = True) -> None:
        if self.verbose:
            print(f"Validation metric improved "
                  f"({self.val_metric_min:.6f} --> {val_metric:.6f}). "
                  "Saving model ...")
        path = self.ckpt_save_path
        if save_multiple:
            path = path[:-3] + f"-{epoch:04d}-{val_metric:.4f}.pt"
        self.save_fn(path, state)
        if update_best:
            self.val_metric_min = val_metric

    def is_best_model(self) -> bool:
        """counter==0 <=> the last evaluated model was the best so far."""
        return self.counter == 0
