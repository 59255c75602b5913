"""VGG2L frontend (counterpart of ``lasr_tpu/modules/vgg.py``).

Two VGG blocks, each two 3x3 convs (padding 1) with ReLU, then floor
max-pooling: (3, 2) after the first block, (2, 2) after the second, so
time goes T → T/6 and frequency idim → idim/4.  The (freq, channel)
flattening, with the optional ``domain_dim`` tag concatenated on every
frame, goes through a Dense to ``odim``.  The layers keep Flax's names
(``Conv_0`` … ``Conv_3``, ``Dense_0``), so the weight bridge carries them
as they are.  Inputs are (B, T, idim) as in ``lasr_tpu``; the convs run
in NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.layers import Conv2d, Linear

_BLOCKS = ((64, (3, 2)), (128, (2, 2)))


def vgg2l_sub_len(length, T: int):
    """Output length under the reference's mask slicing ``[:T-T%3:3]``
    then ``[:T'-T'%2:2]``; ints or tensors."""
    t1 = (T - T % 3 + 2) // 3  # count of kept positions 0,3,6,...
    l1 = min((length + 2) // 3, t1) if isinstance(length, int) \
        else torch.clamp((length + 2) // 3, max=t1)
    t2 = (t1 - t1 % 2 + 1) // 2
    return min((l1 + 1) // 2, t2) if isinstance(l1, int) \
        else torch.clamp((l1 + 1) // 2, max=t2)


class VGG2L(nn.Module):
    def __init__(self, idim: int, odim: int, domain_dim: int = 0):
        super().__init__()
        channels, freq, i = 1, idim, 0
        for ch, pool in _BLOCKS:
            for _ in range(2):
                self.add_module(f"Conv_{i}", Conv2d(channels, ch, 3,
                                                    padding=1))
                channels, i = ch, i + 1
            freq //= pool[1]
        self.Dense_0 = Linear(freq * channels + domain_dim, odim)

    def forward(self, x: torch.Tensor, x_len,
                x_tag: Optional[torch.Tensor] = None):
        """x: (B, T, idim) → ((B, T/6, odim), lengths)."""
        h = x[:, None]                                     # (B, 1, T, F)
        i = 0
        for _, pool in _BLOCKS:
            for _ in range(2):
                h = torch.relu(getattr(self, f"Conv_{i}")(h))
                i += 1
            h = F.max_pool2d(h, pool, pool)
        B, C, Tp, Fp = h.shape
        h = h.permute(0, 2, 3, 1).reshape(B, Tp, Fp * C)
        if x_tag is not None:
            h = torch.cat([h, x_tag[:, None, :].to(h.dtype).expand(
                B, Tp, x_tag.shape[-1])], dim=-1)
        new_len = vgg2l_sub_len(x_len, x.shape[1])
        new_len = min(new_len, Tp) if isinstance(new_len, int) \
            else torch.clamp(new_len, max=Tp)
        return self.Dense_0(h), new_len
