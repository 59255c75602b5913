"""wav2vec/CPC stack (counterpart of ``lasr_tpu/modules/wav2vec.py``).

``ConvFeatureExtractionModel`` (raw-wave strided conv encoder),
``ConvAggegator`` (causal conv context network) and
``Wav2VecPredictionsModel`` (CPC negatives + step predictions), with
``cpc_loss``.  The norms are one-group GroupNorms with their statistics
in float32 whatever the compute dtype.  Inputs and outputs are (B, T, C)
as in ``lasr_tpu``; the convs run in NCW.  Parameters keep Flax's names
(``conv_i``, ``rproj_i``, ``gn_scale_i`` / ``gn_bias_i``,
``project_to_steps``), so the weight bridge carries them as they are.

The prediction model returns fixed-shape ``(logits, labels, valid)``
over (copies, B, steps, T), as ``lasr_tpu``'s does.  Its negatives come
from an explicit ``torch.Generator`` (``sample_indices``), or from given
(N, B, T) indices (``neg_idx``), the form that scores the candidates
another drawer chose.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lasr_tpu_torch.modules.dropout import dropout
from lasr_tpu_torch.modules.layers import Conv1d


def _fp32_group_norm(x, scale, bias, eps=1e-5):
    """GroupNorm with 1 group over (C, T) of x (B, C, T), f32 stats."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = x32.var(dim=(1, 2), keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale[:, None] + bias[:, None]
    return out.to(x.dtype)


class _GroupNormed(nn.Module):
    """Conv layers ``conv_i``, each with its affine one-group norm."""

    def _norm_params(self, dims, affine: bool):
        for i, dim in enumerate(dims):
            self.register_parameter(f"gn_scale_{i}", nn.Parameter(
                torch.ones(dim)) if affine else None)
            self.register_parameter(f"gn_bias_{i}", nn.Parameter(
                torch.zeros(dim)) if affine else None)

    def _layer(self, i, h):
        h = dropout(getattr(self, f"conv_{i}")(h), self.dropout_rate,
                    self.training)
        return torch.relu(_fp32_group_norm(
            h, getattr(self, f"gn_scale_{i}"), getattr(self, f"gn_bias_{i}")))


class ConvFeatureExtractionModel(_GroupNormed):
    """Raw waveform → features via strided 1-D convs."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = (
            (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2),
            (512, 4, 2)),
            dropout: float = 0.0, log_compression: bool = False,
            skip_connections: bool = False, residual_scale: float = 0.5,
            non_affine_group_norm: bool = False):
        super().__init__()
        self.conv_layers = [tuple(c) for c in conv_layers]
        self.dropout_rate = dropout
        self.log_compression = log_compression
        self.skip_connections = skip_connections
        self.scale = math.sqrt(residual_scale)
        channels = 1
        for i, (dim, k, stride) in enumerate(self.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(channels, dim, k, stride,
                                                bias=False))
            channels = dim
        self._norm_params([c[0] for c in self.conv_layers],
                          not non_affine_group_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S) raw wave → (B, T, C)."""
        h = x[:, None]                                      # (B, 1, S)
        for i in range(len(self.conv_layers)):
            residual = h
            h = self._layer(i, h)
            if self.skip_connections and h.shape[1] == residual.shape[1]:
                r_t, t = residual.shape[2], h.shape[2]
                h = (h + residual[:, :, :: r_t // t][:, :, :t]) * self.scale
        if self.log_compression:
            h = torch.log(h.abs() + 1.0)
        return h.transpose(1, 2)


class ConvAggegator(_GroupNormed):
    """Causal conv context network: each layer left-pads k-1 frames (zeros,
    or ``zero_pad`` off: copies of the first frame).  ``embed`` is the
    input's channel count."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = (
            (512, 3, 1),) * 9,
            embed: int = 512, dropout: float = 0.0,
            skip_connections: bool = True, residual_scale: float = 0.5,
            non_affine_group_norm: bool = False, conv_bias: bool = True,
            zero_pad: bool = False):
        super().__init__()
        self.conv_layers = [tuple(c) for c in conv_layers]
        self.dropout_rate = dropout
        self.skip_connections = skip_connections
        self.scale = math.sqrt(residual_scale)
        self.zero_pad = zero_pad
        channels = embed
        for i, (dim, k, stride) in enumerate(self.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(channels, dim, k, stride,
                                                bias=conv_bias))
            if skip_connections and channels != dim:
                self.add_module(f"rproj_{i}", Conv1d(channels, dim, 1,
                                                     bias=False))
            channels = dim
        self._norm_params([c[0] for c in self.conv_layers],
                          not non_affine_group_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) → (B, T', C')."""
        h = x.transpose(1, 2)
        for i, (dim, k, stride) in enumerate(self.conv_layers):
            residual = h
            pad = k - 1
            if self.zero_pad:
                hp = nn.functional.pad(h, (pad, 0))
            else:
                hp = torch.cat([h[:, :, :1].expand(-1, -1, pad), h], dim=2)
            h = self._layer(i, hp)
            if self.skip_connections:
                if hasattr(self, f"rproj_{i}"):
                    residual = getattr(self, f"rproj_{i}")(residual)
                h = (h + residual[:, :, : h.shape[2]]) * self.scale
        return h.transpose(1, 2)


class _StepProjection(nn.Module):
    """Flax's ``DenseGeneral`` to (out_dim, steps): ``weight`` (steps,
    out, in) is its kernel (in, out, steps) reversed, ``bias`` (out,
    steps) its bias."""

    def __init__(self, in_dim: int, out_dim: int, steps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(steps, out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim, steps))
        nn.init.normal_(self.weight, std=in_dim ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in) → (B, T, out, steps)."""
        return torch.einsum("bti,soi->btos", x, self.weight) + self.bias


class Wav2VecPredictionsModel(nn.Module):
    """CPC step-prediction head."""

    def __init__(self, in_dim: int, out_dim: int, prediction_steps: int = 12,
                 n_negatives: int = 10, cross_sample_negatives: bool = False,
                 sample_distance: Optional[int] = None, dropout: float = 0.0,
                 offset: int = 1, balanced_classes: bool = False):
        super().__init__()
        self.prediction_steps = prediction_steps
        self.n_negatives = n_negatives
        self.cross_sample_negatives = cross_sample_negatives
        self.dropout_rate = dropout
        self.offset = offset
        self.project_to_steps = _StepProjection(in_dim, out_dim,
                                                prediction_steps)

    def sample_indices(self, B: int, T: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
        """(N, B, T) negative indices: frames of the same row in [0, T),
        or with ``cross_sample_negatives`` flat (row, frame) in [0, B·T)."""
        high = B * T if self.cross_sample_negatives else T
        return torch.randint(0, high, (self.n_negatives, B, T),
                             generator=generator, device=device)

    def negatives(self, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """y: (B, T, C) targets, idx: (N, B, T) → (N, B, T, C)."""
        B, T, C = y.shape
        idx = idx.to(y.device).long()
        if self.cross_sample_negatives:
            return y.reshape(B * T, C)[idx]
        return y[torch.arange(B, device=y.device)[None, :, None], idx]

    def forward(self, context: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                neg_idx: Optional[torch.Tensor] = None):
        """context: (B, T, in_dim) aggregator output; targets: (B, T,
        out_dim) encoder output; the negatives are ``neg_idx``'s, else
        drawn from ``generator``.  Returns (logits, labels, valid) over
        (1+n_negatives, B, steps, T)."""
        B, T, _ = targets.shape
        if neg_idx is None:
            neg_idx = self.sample_indices(B, T, generator, targets.device)
        cands = torch.cat([targets[None], self.negatives(targets, neg_idx)])
        preds = dropout(self.project_to_steps(context), self.dropout_rate,
                        self.training)                      # (B, T, C, S)
        t_idx = torch.arange(context.shape[1], device=context.device)
        logits, valid = [], []
        for i in range(self.prediction_steps):
            off = i + self.offset
            shifted = torch.roll(cands, -off, dims=2)       # target at t+off
            logits.append(torch.einsum("btc,kbtc->kbt", preds[..., i],
                                       shifted))
            valid.append(t_idx < context.shape[1] - off)
        logits = torch.stack(logits, dim=2)                 # (K, B, S, T)
        valid = torch.stack(valid)[None, None].expand(logits.shape)
        labels = torch.zeros_like(logits)
        labels[0] = 1.0
        return logits, labels, valid


def cpc_loss(logits, labels, valid):
    """Masked binary sigmoid CE over the CPC predictions."""
    bce = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return torch.where(valid, bce, 0.0).sum() / torch.clamp(
        valid.sum(), min=1)
