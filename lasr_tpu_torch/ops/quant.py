"""Int8 matmul with straight-through gradients, and a Linear drop-in
(counterpart of ``lasr_tpu/ops/quant.py``).

Symmetric absmax scales, constant along each product's contraction so
they factor out of the sum:

  - forward ``y = x @ w``: x per row over K, w per output column over K;
    both quantized (round half to even, clip at ±127), an int8 x int8
    product with int32 accumulation, dequantized as ``acc · sx · sw``;
  - backward (``bwd_int8=True``): ``dx = g @ w.T`` with g per row and
    w.T per column over N, ``dw = x.T @ g`` with x.T per row and g per
    column over M, each quantized along its own contraction;
    ``bwd_int8=False`` takes both from the unquantized tensors in
    float32.  The straight-through estimator: rounding and clipping
    count as the identity.

The int32 products are exact, so a forward equals ``lasr_tpu``'s to the
last bit where the dequantization multiplies in the same order.  The
integer product is ``torch._int_mm`` (``lasr_tpu`` computes it as an XLA
``lax.dot`` with int32 accumulation, not in a Pallas kernel); on CUDA its
operands are padded with zero rows / columns to its shape rules (more
than 16 rows, K and N multiples of 8), which change no scale and no
product.

``QuantLinear`` is ``modules.layers.Linear`` with that product: the
same parameters and state_dict names (``QuantDense``'s ``nn.Dense``
tree in ``lasr_tpu``), float32 master weights, the result cast to the
compute dtype before the bias is added.  ``PositionwiseFeedForward(...,
int8=True)`` builds its two Linears so (``encoder_ff_int8``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lasr_tpu_torch.modules.layers import Linear


def absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric per-slice scale: max|x| along ``dim`` mapped to 127."""
    m = x.float().abs().amax(dim=dim, keepdim=True)
    return torch.clamp(m, min=1e-8) / 127.0


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip at ±127, int8."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) int8 → int32, padded on CUDA to ``_int_mm``'s
    shape rules."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda:
        pm = max(24, -(-M // 8) * 8) - M
        pk, pn = (-K) % 8, (-N) % 8
        if pm or pk or pn:
            a = F.pad(a, (0, pk, 0, pm))
            b = F.pad(b, (0, pn, 0, pk))
            return torch._int_mm(a, b)[:M, :N]
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_dot(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
             sb: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) through int8 with scales ``sa`` (M, 1) and ``sb``
    (1, N), dequantized to float32."""
    acc = _int_mm(quantize_int8(a, sa), quantize_int8(b, sb))
    return acc.float() * sa * sb


class Int8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bwd_int8: bool):
        ctx.save_for_backward(x, w)
        ctx.bwd_int8 = bwd_int8
        x2 = x.reshape(-1, x.shape[-1])
        y = int8_dot(x2, absmax_scale(x2, 1), w, absmax_scale(w, 0))
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1]).float()
        g2 = g.reshape(-1, g.shape[-1]).float()
        wf = w.float()
        if ctx.bwd_int8:
            wt = wf.t()
            dx = int8_dot(g2, absmax_scale(g2, 1), wt, absmax_scale(wt, 0))
            xt = x2.t()
            dw = int8_dot(xt, absmax_scale(xt, 1), g2, absmax_scale(g2, 0))
        else:
            dx = g2 @ wf.t()
            dw = x2.t() @ g2
        return (dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                bwd_int8: bool = True) -> torch.Tensor:
    """``x @ w`` through int8 (x: (..., K), w: (K, N)); float32 out,
    straight-through gradients."""
    return Int8Matmul.apply(x, w, bwd_int8)


class QuantLinear(Linear):
    """``Linear`` whose product is ``int8_matmul`` (``QuantDense`` with its
    default ``bwd_int8=True``, which every ``lasr_tpu`` caller keeps)."""

    # tensor parallelism leaves it whole (``parallel.sharding``): the
    # absmax scales span the contraction that a split would cut
    splittable = False

    def forward(self, x):
        y = int8_matmul(x, self.weight.t()).to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)
