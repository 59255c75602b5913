"""Conv2d subsampling frontends (counterpart of
``lasr_tpu/modules/subsampling.py``).

``Conv2dSubsampling``: VALID convs over (time, freq) in NCHW, one per
``stages`` entry (kernel, stride), ReLU after each, then a linear
projection of the (channel, freq)-ordered flattening — the row order of
the reference's ``transpose(1,2).flatten`` and of the JAX
``_FreqChanDense`` kernel — and the positional encoding.  Two stride-2
3x3 convs (T/4); ``Conv2dSubsampling6`` a stride-2 3x3 then a stride-3
5x5 (T/6), ``Conv2dSubsampling8`` three stride-2 3x3 (T/8).

``Conv2dUpsampling``: the transpose-conv inverse, (B, T', odim) →
(B, 4T'+3, idim).  Flax's ``nn.ConvTranspose`` (``transpose_kernel``
off) correlates the input-dilated map with its kernel as it is; torch's
``ConvTranspose2d`` correlates with the kernel flipped in both spatial
axes, so the bridged weight is the Flax kernel flipped
(``utils.weights.flax_to_state_dict``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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
    """T → T/4 (two stride-2 3x3 convs).  ``pos_enc`` defaults to the
    absolute ``PositionalEncoding(odim, dropout_rate)``."""

    # (kernel, stride) per conv stage; the subclasses change this
    stages = ((3, 2), (3, 2))

    def __init__(self, idim: int, odim: int,
                 pos_enc: Optional[nn.Module] = None,
                 dropout_rate: float = 0.1):
        super().__init__()
        layers, channels, freq = [], 1, idim
        for kernel, stride in self.stages:
            layers += [Conv2d(channels, odim, kernel, stride), nn.ReLU()]
            channels, freq = odim, conv_out_T(freq, kernel, stride)
        self.conv = nn.Sequential(*layers)
        self.out = nn.Sequential(Linear(odim * freq, odim))
        self.pos_enc = PositionalEncoding(odim, dropout_rate) \
            if pos_enc is None else pos_enc

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


class Conv2dSubsampling6(Conv2dSubsampling):
    """T → T/6 (a stride-2 3x3 conv, then a stride-3 5x5)."""
    stages = ((3, 2), (5, 3))


class Conv2dSubsampling8(Conv2dSubsampling):
    """T → T/8 (three stride-2 3x3 convs)."""
    stages = ((3, 2), (3, 2), (3, 2))


class Conv2dUpsampling(nn.Module):
    """T' → 4T'+3 with the frequency axis padded or trimmed back to
    ``idim``: a Dense to (middle, odim), ReLU, two stride-2 3x3
    transpose convs (ReLU between them) down to one channel.  The
    parameters keep Flax's names (``Dense_0``, ``ConvTranspose_0/1``);
    ``dropout_rate`` is accepted and unused, as in ``lasr_tpu``."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.idim, self.odim = idim, odim
        self.middle = ((idim - 1) // 2 - 1) // 2
        self.Dense_0 = Linear(odim, odim * self.middle)
        self.ConvTranspose_0 = nn.ConvTranspose2d(odim, odim, 3, 2)
        self.ConvTranspose_1 = nn.ConvTranspose2d(odim, 1, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T', odim) → (B, 4T'+3, idim)."""
        B, T, _ = x.shape
        h = torch.relu(self.Dense_0(x).reshape(B, T, self.middle, self.odim))
        h = torch.relu(self.ConvTranspose_0(h.permute(0, 3, 1, 2)))
        h = self.ConvTranspose_1(h)[:, 0]                 # (B, T'', F'')
        freq = h.shape[-1]
        return F.pad(h, (0, self.idim - freq)) if freq < self.idim \
            else h[..., : self.idim]
