"""Seed-recompute dropout (counterpart of ``lasr_tpu/ops/dropout.py``):
the forward is bit-identical to ``modules.dropout``'s ``dropout`` drawing
from the same generator state, and the backward draws the mask again
from the generator state saved at the forward (on CUDA the Philox seed
and offset, 16 bytes) instead of keeping the mask for the backward.

An opt-in module, wired to no model knob, as in ``lasr_tpu``: whether
saving the mask or drawing it twice is cheaper is a measurement of its
own (``lasr_tpu`` measured it slower on the TPU, where its attention
interior is rematerialized).  The gradient is ``where(mask, g / (1 -
rate), 0)``, what autograd of ``dropout`` gives.
"""

from __future__ import annotations

import torch
from torch import nn

from lasr_tpu_torch.modules.dropout import _generator, keep_mask


class _SeedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, shard, gen):
        ctx.meta = (gen.device, gen.get_state(), rate, shard, x.shape,
                    x.device)
        return torch.where(keep_mask(x, rate, shard, gen), x / (1.0 - rate),
                           0.0)

    @staticmethod
    def backward(ctx, g):
        device, state, rate, shard, shape, x_device = ctx.meta
        gen = torch.Generator(device=device)
        gen.set_state(state)
        like = torch.empty(shape, device=x_device)
        keep = keep_mask(like, rate, shard, gen)
        return torch.where(keep, g / (1.0 - rate), 0.0), None, None, None


def seed_dropout(x: torch.Tensor, rate: float, training: bool,
                 shard=None) -> torch.Tensor:
    """``modules.dropout.dropout`` with the mask drawn again in the
    backward (same arguments, same draws)."""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return _SeedDropout.apply(x, rate, shard, _generator())


class SeedDropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return seed_dropout(x, self.rate, self.training)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
