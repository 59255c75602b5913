"""Positional encodings (counterpart of ``lasr_tpu/modules/embedding.py``).

  - ``PositionalEncoding``: x·√d + sinusoid[offset : offset+T]; the
    offset is an int, or a (N,) tensor of per-row offsets (the streaming
    encoder's chunk rows), whose rows are computed in float32 as
    ``lasr_tpu``'s ``_sinusoid_at`` computes them.
  - ``ScaledPositionalEncoding``: x + α·sinusoid[offset : offset+T], α a
    learnable scalar (``alpha``, initialized to 1; the one parameter of
    these modules).
  - ``RelPositionalEncoding``: (x·√d, pos_emb of length 2T-1) for
    Transformer-XL attention; index T-1 is distance 0, earlier entries are
    positive distances (key left of the query), later ones negative.

Tables are computed (in float64, then cast to float32) for the rows a call
needs; like the reference's non-persistent ``pe`` buffer they are not in
the state_dict.  In train mode the scaled input, and (``drop_pos``) the
relative table, take dropout at ``dropout_rate``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from lasr_tpu_torch.modules.dropout import dropout
from lasr_tpu_torch.modules.layers import Conv1d


def sinusoid_rows(positions, d_model: int) -> np.ndarray:
    """(len(positions), d_model) float32 sinusoid rows at the given (signed)
    positions; sin on even columns, cos on odd.  Row p equals row p of
    ``sinusoid_table`` for every length that contains it."""
    pos = np.asarray(positions, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    table = np.zeros((pos.shape[0], d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table.astype(np.float32)


def sinusoid_table(length: int, d_model: int,
                   negative: bool = False) -> np.ndarray:
    """(length, d_model) float32 sinusoid table over positions 0..length-1
    (negated when ``negative``)."""
    pos = np.arange(length, dtype=np.float64)
    return sinusoid_rows(-pos if negative else pos, d_model)


def sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoid rows at integer ``positions`` (...,) → (..., d_model),
    computed in float32 on the positions' device (``lasr_tpu``'s
    ``_sinusoid_at``; ``sinusoid_rows`` computes in float64)."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10000.0) / d_model))
    ang = positions[..., None].to(torch.float32) * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *positions.shape, d_model)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 5000):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def rows(self, x: torch.Tensor, offset) -> torch.Tensor:
        """The sinusoid rows x's T positions take from ``offset``, in x's
        dtype: (1, T, d), or (N, T, d) for per-row offsets."""
        T = x.shape[1]
        if torch.is_tensor(offset) and offset.ndim == 1:
            return sinusoid_at(offset[:, None] + torch.arange(
                T, device=offset.device), self.d_model).to(x.device, x.dtype)
        offset = int(offset)
        return torch.from_numpy(sinusoid_rows(
            np.arange(offset, offset + T), self.d_model)).to(
                x.device, x.dtype)[None]

    def forward(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        x = x * math.sqrt(self.d_model) + self.rows(x, offset)
        return dropout(x, self.dropout_rate, self.training)


class ScaledPositionalEncoding(PositionalEncoding):
    """x + α·sinusoid: the input unscaled, the table times the learnable
    scalar ``alpha`` (float32, cast to x's dtype as Flax casts it)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_len: int = 5000):
        super().__init__(d_model, dropout_rate, max_len)
        self.alpha = nn.Parameter(torch.ones(()))

    def forward(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        x = x + self.alpha.to(x.dtype) * self.rows(x, offset)
        return dropout(x, self.dropout_rate, self.training)


class RelPositionalEncoding(nn.Module):
    """Returns (x·√d, relative pos-emb (1, 2T-1, d)).  ``drop_pos=False``
    (the conformer's ``pos_dropout_mode="rotated"``) leaves the table
    undropped; x takes its dropout either way."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 max_dist: int = -1, max_len: int = 5000,
                 drop_pos: bool = True):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.max_dist = max_dist
        self.drop_pos = drop_pos

    def forward(self, x: torch.Tensor):
        T = x.shape[1]
        dist = (T - 1) - np.arange(2 * T - 1)       # T-1 .. -(T-1)
        if self.max_dist >= 0:
            dist = np.clip(dist, -self.max_dist, self.max_dist)
        pos_emb = torch.from_numpy(sinusoid_rows(dist, self.d_model)).to(
            x.device, x.dtype)[None]
        return (dropout(x * math.sqrt(self.d_model), self.dropout_rate,
                        self.training),
                dropout(pos_emb, self.dropout_rate,
                        self.training and self.drop_pos))


class ConvPosEmbedding(nn.Module):
    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 kernel_size: int = 64, groups: int = 16):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Conv_0 = Conv1d(d_model, d_model, kernel_size,
                             padding=kernel_size // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, d_model) → the same shape."""
        h = self.Conv_0(x.transpose(1, 2))[..., : x.shape[1]].transpose(1, 2)
        return x + torch.relu(dropout(h, self.dropout_rate, self.training))
