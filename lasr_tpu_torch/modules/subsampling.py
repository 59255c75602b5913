"""Conv2d subsampling frontend (counterpart of
``lasr_tpu/modules/subsampling.py``).

Two stride-2 VALID 3x3 convs over (time, freq) in NCHW, ReLU after each,
then a linear projection of the (channel, freq)-ordered flattening — the
row order of the reference's ``transpose(1,2).flatten`` and of the JAX
``_FreqChanDense`` kernel — and the positional encoding.
"""

from __future__ import annotations

import torch
from torch import nn

from lasr_tpu_torch.modules.embedding import PositionalEncoding
from lasr_tpu_torch.modules.layers import Conv2d, Linear


def conv_out_T(T: int, kernel: int, stride: int) -> int:
    """Static output length of a VALID conv along time."""
    return (T - kernel) // stride + 1


def subsampled_len(length, T: int, kernel: int = 3, stride: int = 2,
                   solo: bool = False):
    """Valid output count under the reference's ``mask[:, :-(k-1):s]``
    convention; ints or tensors.

    ``solo=True`` gives the length the utterance has when encoded ALONE
    (the per-row cap is ``length - (kernel-1)`` instead of the batch-wide
    ``T - (kernel-1)``), which is what batched decode must reproduce."""
    if isinstance(length, int):
        capped = max(length - (kernel - 1), 0) if solo \
            else min(length, T - (kernel - 1))
    elif solo:
        capped = torch.clamp(length - (kernel - 1), min=0)
    else:
        capped = torch.clamp(length, max=T - (kernel - 1))
    return (capped + stride - 1) // stride


class Conv2dSubsampling(nn.Module):
    """T → T/4 (two stride-2 3x3 convs)."""

    stages = ((3, 2), (3, 2))

    def __init__(self, idim: int, odim: int, pos_enc: nn.Module,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(1, odim, 3, 2), nn.ReLU(),
            Conv2d(odim, odim, 3, 2), nn.ReLU())
        freq = idim
        for kernel, stride in self.stages:
            freq = conv_out_T(freq, kernel, stride)
        self.out = nn.Sequential(Linear(odim * freq, odim))
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, x_len: torch.Tensor,
                solo_len: bool = False, offset=0):
        """x: (B, T, idim) → (out, lengths); ``out`` is (B, T', odim), or
        the (x, pos_emb) pair of a relative encoding.  ``offset``: the
        absolute encoding's start position, an int or a (B,) tensor of
        per-row offsets; a relative encoding takes none."""
        h = self.conv(x[:, None])                         # (B, C, T', F')
        T, new_len = x.shape[1], x_len
        for kernel, stride in self.stages:
            new_len = subsampled_len(new_len, T, kernel, stride,
                                     solo=solo_len)
            T = conv_out_T(T, kernel, stride)
        B, C, Tp, Fp = h.shape
        h = self.out(h.transpose(1, 2).reshape(B, Tp, C * Fp))
        if isinstance(offset, int) and offset == 0:
            return self.pos_enc(h), new_len
        if not isinstance(self.pos_enc, PositionalEncoding):
            raise ValueError("a positional offset needs the absolute "
                             "PositionalEncoding")
        return self.pos_enc(h, offset), new_len
