"""Audio-classification head stack (counterpart of
``lasr_tpu/modules/fillier.py``): the separable-ish conv pyramid blocks,
the 6-block embedding model and the max-pool classification head.

The public layout is ``lasr_tpu``'s: blocks take and return NHWC; the
convs run in NCHW inside (``nchw``), and ``EmbeddingModel`` permutes once
at each end.  A block's first conv infers its input channels at the
first call, as Flax's ``nn.Conv`` does (a lazy conv; a state_dict loads
into it before that).  The layers keep Flax's names (``Conv_k``,
``ConvBlock_k``, ``ConvBlockFinal_0``, ``Dense_k``), so the weight bridge
carries them as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.dropout import dropout
from lasr_tpu_torch.modules.layers import Conv2d, Linear

_ROW, _COL = ((1, 3), (0, 1)), ((3, 1), (1, 0))   # (kernel, padding)


def _conv(channels_in, channels_out, shape):
    kernel, padding = shape
    if channels_in is None:
        return nn.LazyConv2d(channels_out, kernel, padding=padding)
    return Conv2d(channels_in, channels_out, kernel, padding=padding)


class _Block(nn.Module):
    """Convs of ``shapes`` (a ReLU'd dropout after those in ``acts``, a
    2x2 max-pool after the one in ``pool``)."""

    shapes = ()
    acts = ()
    pool = None

    def __init__(self, channel_out: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        for i, shape in enumerate(self.shapes):
            self.add_module(f"Conv_{i}", _conv(None if i == 0 else
                                               channel_out, channel_out,
                                               shape))

    def nchw(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.shapes)):
            h = getattr(self, f"Conv_{i}")(h)
            if i in self.acts:
                h = torch.relu(dropout(h, self.dropout_rate, self.training))
            if i == self.pool:
                h = F.max_pool2d(h, 2, 2)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC."""
        return self.nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvBlock(_Block):
    """(1,3) conv, (3,1) conv, dropout, ReLU, 2x2 max-pool, (3,1) conv,
    (1,3) conv, dropout, ReLU."""
    shapes = (_ROW, _COL, _COL, _ROW)
    acts = (1, 3)
    pool = 1


class ConvBlockFinal(_Block):
    """Two (3,1) convs, each followed by dropout and ReLU."""
    shapes = (_COL, _COL)
    acts = (0, 1)


class EmbeddingModel(nn.Module):
    """6-block pyramid: 24→48→72→96→96 + final."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        for i, ch in enumerate((24, 48, 72, 96, 96)):
            self.add_module(f"ConvBlock_{i}", ConvBlock(ch, dropout_rate))
        self.ConvBlockFinal_0 = ConvBlockFinal(96, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC → (B, H/32, W/32, 96)."""
        h = x.permute(0, 3, 1, 2)
        for i in range(5):
            h = getattr(self, f"ConvBlock_{i}").nchw(h)
        return self.ConvBlockFinal_0.nchw(h).permute(0, 2, 3, 1)


class Classification(nn.Module):
    """Max-pool over the embedding axis then a linear classifier
    (``conv_1x1``: a Dense of ``embedding_channel`` first)."""

    def __init__(self, embedding_channel: int, embedding_size: int,
                 output_size: int, dropout_rate: float = 0.1,
                 conv_1x1: bool = False):
        super().__init__()
        self.embedding_channel = embedding_channel
        self.embedding_size = embedding_size
        self.dropout_rate = dropout_rate
        self.conv_1x1 = conv_1x1
        layers = [embedding_channel] * conv_1x1 + [output_size]
        for i, width in enumerate(layers):
            self.add_module(f"Dense_{i}", Linear(embedding_channel, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, E, 1) channel-major like the reference."""
        assert x.shape[1] == self.embedding_channel
        assert x.shape[2] == self.embedding_size
        h = x[..., 0].amax(dim=2)                          # (B, C)
        if self.conv_1x1:
            h = self.Dense_0(h)
        h = dropout(h, self.dropout_rate, self.training)
        return getattr(self, f"Dense_{int(self.conv_1x1)}")(h)
