"""Position-wise feed-forward (counterpart of
``lasr_tpu/modules/feed_forward.py``): w_2(dropout(act(w_1(x)))), swish
in the Conformer blocks and ReLU in the decoder.  ``int8=True`` runs both
Linears through int8 products (``ops.quant.QuantLinear``, the same
parameters and names)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from lasr_tpu_torch.modules.dropout import dropout, time_shard
from lasr_tpu_torch.modules.layers import Linear


class PositionwiseFeedForward(nn.Module):
    # (rank, size): the hidden units are this model rank's part
    # (``parallel.tensor``); None when whole
    hidden_shard = None

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.1,
                 activation: Callable = torch.relu, int8: bool = False):
        super().__init__()
        if int8:
            from lasr_tpu_torch.ops.quant import QuantLinear as linear
        else:
            linear = Linear
        self.int8 = int8
        self.w_1 = linear(idim, hidden_units)
        self.w_2 = linear(hidden_units, idim)
        self.activation = activation
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = None if self.hidden_shard is None \
            else (-1, *self.hidden_shard)
        h = dropout(self.activation(self.w_1(x)), self.dropout_rate,
                    self.training, (shard, time_shard(1)))
        return self.w_2(h)
