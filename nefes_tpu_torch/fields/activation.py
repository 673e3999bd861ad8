"""Custom activations; port of nefes_tpu/fields/activation.py (reference
script/models/activation.py).

``trunc_exp``: exp whose gradient is taken at the input clamped to
[-15, 15], which keeps the density optimisation of instant-ngp style
fields stable (reference activation.py:8-20).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def trunc_softplus(x: torch.Tensor) -> torch.Tensor:
    """Softplus of the input clamped to [-15, 15] (activation.py:22-24);
    the gradient is zero outside the clamp (and half at a bound itself,
    as jnp.clip's)."""
    x = torch.minimum(torch.maximum(x, x.new_tensor(-15.0)),
                      x.new_tensor(15.0))
    return F.softplus(x)
