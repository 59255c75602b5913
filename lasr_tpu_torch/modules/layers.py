"""Layers with a compute dtype: the port's copy of Flax's mixed-precision
policy, which ``lasr_tpu``'s ``dtype=jnp.bfloat16`` models follow.

Parameters stay float32; each layer computes in its ``dtype`` (float32
unless ``set_compute_dtype`` says otherwise) and casts where Flax casts:

  - ``Linear``, ``Conv1d``, ``Conv2d`` (``nn.Dense`` / ``nn.Conv``): input,
    weight and bias are cast to ``dtype`` (``promote_dtype``), so the output
    is ``dtype``;
  - ``LayerNorm`` (``nn.LayerNorm``): statistics and the affine map in
    float32 from the float32 input, the result cast to ``dtype``;
  - ``Embedding`` (``nn.Embed``): the float32 table's rows cast to
    ``dtype``.

(``modules.conformer.FlaxBatchNorm1d`` keeps float32 statistics and
running averages the same way.)  So under bfloat16 the residual stream is
bfloat16 from the input layer on, unlike ``torch.autocast``, which keeps
the residual adds and LayerNorm outputs in float32.  Gradients reach the
float32 parameters through the casts in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Computes:
    """Mixin: the layer's compute dtype (set by ``set_compute_dtype``)."""

    dtype = torch.float32

    def _cast(self, *tensors):
        return [None if t is None else t.to(self.dtype) for t in tensors]


class Linear(Computes, nn.Linear):
    def forward(self, x):
        return F.linear(*self._cast(x, self.weight, self.bias))


class Conv1d(Computes, nn.Conv1d):
    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class Conv2d(Computes, nn.Conv2d):
    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class LayerNorm(Computes, nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embedding(Computes, nn.Embedding):
    def forward(self, ids):
        return super().forward(ids).to(self.dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every layer of ``module`` with a compute dtype compute in
    ``dtype``; parameters and buffers are left as they are."""
    for m in module.modules():
        if isinstance(m, Computes):
            m.dtype = dtype

