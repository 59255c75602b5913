"""Mask construction (counterpart of ``lasr_tpu/utils/masks.py``).

Semantics of the reference ``lasr/utils/mask.py``:
  - ``make_pad_mask(lengths, maxlen)`` → True at PADDED positions (B, T)
  - ``subsequent_mask(size)``          → lower-triangular causal (T, T)
  - ``target_mask(ys_in, ignore_id)``  → valid ∧ causal (B, T, T)
  - ``chunk_attention_mask(size, chunk, left_chunks)`` → the streaming
    block-chunk mask (T, T) of the dual encoder
"""

from __future__ import annotations

import torch


def make_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """True at padded positions. lengths: (B,) int; returns (B, maxlen)."""
    pos = torch.arange(maxlen, device=lengths.device)
    return pos[None, :] >= lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    return ~make_pad_mask(lengths, maxlen)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask (size, size) bool; True = attendable."""
    return torch.tril(torch.ones(size, size, dtype=torch.bool, device=device))


def target_mask(ys_in: torch.Tensor, ignore_id: int = -1) -> torch.Tensor:
    """Decoder self-attention mask (B, L, L): valid-token ∧ causal."""
    valid = ys_in != ignore_id
    causal = subsequent_mask(ys_in.shape[-1], device=ys_in.device)
    return valid[:, None, :] & causal[None, :, :]


def chunk_attention_mask(size: int, chunk, left_chunks: int = -1,
                         device=None) -> torch.Tensor:
    """Block-chunk streaming mask (size, size) bool: frame i attends to
    frame j iff j's chunk is not after i's (all frames of a chunk see
    each other) and, when ``left_chunks`` >= 0, is among the last
    ``left_chunks`` chunks before it."""
    idx = torch.div(torch.arange(size, device=device), chunk,
                    rounding_mode="floor")
    ok = idx[None, :] <= idx[:, None]
    if left_chunks >= 0:
        ok = ok & (idx[None, :] > idx[:, None] - left_chunks - 1)
    return ok
