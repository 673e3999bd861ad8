"""flax's default initialisers for the port's modules: where a pipeline
trains from random weights (the field zoo, the probe's accuracy command),
they start from the distribution the JAX package's modules start from."""

from __future__ import annotations

import torch
from torch import nn

# the std of a standard normal truncated at +-2 std
_TRUNC_STD = .87962566103423978


@torch.no_grad()
def lecun_normal_(module: nn.Module,
                  generator: torch.Generator | None = None) -> None:
    """Every Linear and Conv2d of module: the weight truncated normal at 2
    std of variance 1 / fan_in (flax's lecun_normal; fan_in the inputs
    times the kernel's area), the bias 0 (flax's zeros). Drawn on the CPU
    from generator (torch's global one when None), in module order, so
    that a seed fixes the weights whatever device they live on."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = mod.weight[0].numel() ** -0.5 / _TRUNC_STD
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.weight.copy_(w)
            mod.bias.zero_()
