"""Fused relative-position attention: the CUDA kernels, their plain
versions and the autograd Function over them.

Counterpart of ``lasr_tpu/ops/rel_attention.py``: computes
``softmax_j[(q_u·k_j + q_v·p_{T-1-i+j}) / sqrt(dk) + mask] @ v``
flash-style (``csrc/rel_attention.cu``), never materializing the score
matrix.  Both kernels run every product on the tensor cores (WMMA TF32
tiles, 3xTF32 for f32 inputs), and the rel-shift is an index remap between
plain products: the scores are ``q_u·k^T`` and ``q_v·Pwin^T`` over a window
``Pwin`` of ``p``.  In the forward each warp owns 16 query rows (a 48-row
window, one block barrier per key tile, the online softmax and ``O`` in
registers).  The backward (``csrc/rel_attention_bwd.cu``) recomputes the
probabilities from the forward's ``lse`` over 32-row tiles and a 64-row
window, and ``dz`` goes back through the same remap into ``dW``, so
``dq_v = dW·Pwin`` and ``dPwin = dW^T·q_v`` are plain products too.  A key
pass owns dk/dv, a query pass dq_u/dq_v and a dp partial per (bh, query
tile), and a last kernel adds the partials in a fixed order (no atomics).
``rel_attention_context`` pairs the two in a ``torch.autograd.Function``,
as the JAX package's ``custom_vjp`` does.  The kernels take head widths
up to ``DK_MAX`` = 128 (the 1B config's dk = 80 through their wide-head
forms); a wider head raises before any launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lasr_tpu_torch.ops.rot_attention import (
    _bind, _check, _check_kv_len, _device_path, _key_mask, _launch,
    _masked_softmax_context, _probs_and_score_grad, _ptr)


def _rel_scores(q_u, q_v, k, p):
    """(scaled scores (BH, T, T) f32, rel-shift index (T, T)):
    s[i, j] = (q_u_i·k_j + q_v_i·p[T-1-i+j]) / sqrt(dk)."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    ac = q_u.float() @ k.float().transpose(1, 2)
    w = (q_v.float().reshape(BH // H, H, T, dk)
         @ p.float().transpose(1, 2)[None]).reshape(BH, T, 2 * T - 1)
    # rel shift: bd[i, j] = w[i, T-1-i+j]
    idx = (T - 1 - torch.arange(T, device=w.device)[:, None]
           + torch.arange(T, device=w.device)[None, :])
    bd = torch.gather(w, 2, idx[None].expand(BH, T, T))
    return (ac + bd) / math.sqrt(dk), idx


def rel_attention_reference(q_u, q_v, k, v, p, kv_len):
    """Plain PyTorch version of the kernel (the blockless math of
    ``lasr_tpu/ops/rel_attention.py:_xla_reference``), in f32; on bf16
    inputs P is rounded to bf16 before P·v, as the kernels round it.

    q_u/q_v/k/v: (BH, T, dk) with bh = b*H + h; p: (H, 2T-1, dk) shared
    across the batch; kv_len: (BH,).  Returns (out (BH, T, dk), lse
    (BH, T) f32); rows with kv_len == 0 give zeros and lse = +inf."""
    T = q_u.shape[1]
    s, _ = _rel_scores(q_u, q_v, k, p)
    return _masked_softmax_context(s, _key_mask(kv_len, T, s.device), v,
                                   q_u.dtype)


def rel_attention_backward_reference(q_u, q_v, k, v, p, kv_len, out, lse,
                                     dout):
    """Plain PyTorch version of the backward kernel (the math of
    ``lasr_tpu/ops/rel_attention.py:_bwd_kernel``), in f32, from the
    forward's ``out`` and ``lse``; as in that kernel nothing is rounded
    before the gradients themselves, bf16 inputs included.

    Returns (dq_u, dq_v, dk, dv, dp) in the dtypes of q_u, q_v, k, v, p;
    dp[h, r] sums the inverse rel-shift of dz over the batch."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    s, idx = _rel_scores(q_u, q_v, k, p)
    P, dz = _probs_and_score_grad(s, _key_mask(kv_len, T, s.device), lse, v,
                                  out, dout, dk)
    # inverse rel-shift: dw[i, T-1-i+j] = dz[i, j]
    dw = torch.zeros(BH, T, 2 * T - 1, dtype=dz.dtype, device=dz.device)
    dw.scatter_(2, idx[None].expand(BH, T, T), dz)
    dw = dw.reshape(BH // H, H, T, 2 * T - 1)
    dq_v = (dw @ p.float()[None]).reshape(BH, T, dk)
    dp = torch.einsum("bhip,bhid->hpd", dw,
                      q_v.float().reshape(BH // H, H, T, dk))
    return ((dz @ k.float()).to(q_u.dtype), dq_v.to(q_v.dtype),
            (dz.transpose(1, 2) @ q_u.float()).to(k.dtype),
            (P.transpose(1, 2) @ dout.float()).to(v.dtype), dp.to(p.dtype))


# the widest head the kernels take (csrc/rel_attention*.cu's DK_MAX)
DK_MAX = 128


def _check_heads(name, BH, H):
    if H < 1 or BH % H:
        raise ValueError(f"{name}: BH={BH} is not a multiple of H={H}")


def _check_kernel_width(name, dk):
    """Before a launch: the kernels take dk <= DK_MAX."""
    if dk > DK_MAX:
        raise ValueError(f"{name}: the kernel takes head widths up to "
                         f"{DK_MAX}, got dk={dk}")


def rel_attention_forward(q_u, q_v, k, v, p, kv_len):
    """Rel-pos attention context and log-sum-exp.

    Shapes as ``rel_attention_reference``; kv_len is int32.  On CUDA
    tensors this launches the Hopper kernel (counted in
    ``rel_attention_forward.launches``); on CPU tensors it runs the plain
    version.  Any other device raises; on CUDA, dk > ``DK_MAX`` raises
    ``ValueError`` before the launch."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    _check_heads("rel_attention", BH, H)
    _check("rel_attention", [q_u, q_v, k, v, p],
           [(BH, T, dk)] * 4 + [(H, 2 * T - 1, dk)])
    kv_len = _check_kv_len("rel_attention", kv_len, BH, q_u.device)
    if not _device_path("rel_attention", q_u.device):
        return rel_attention_reference(q_u, q_v, k, v, p, kv_len)
    _check_kernel_width("rel_attention", dk)
    out = torch.empty_like(q_u)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch("rel_attention",
            _bind("rel_attention", "lasr_rel_attention_fwd", 8, 5),
            _ptr(q_u), _ptr(q_v), _ptr(k), _ptr(v), _ptr(p), _ptr(kv_len),
            _ptr(out), _ptr(lse), BH, T, dk, H,
            int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    rel_attention_forward.launches += 1
    return out, lse


rel_attention_forward.launches = 0

# rows of the backward's tiles: its query pass writes a dp partial of
# TILE * (ceil(T / TILE) + 1) rows per (bh, query tile)
TILE = 32


def rel_attention_backward(q_u, q_v, k, v, p, kv_len, out, lse, dout):
    """Gradients (dq_u, dq_v, dk, dv, dp) of ``rel_attention_forward``'s
    output.

    ``out`` and ``lse`` are the forward's, ``dout`` the output's gradient
    (the inputs' dtype).  On CUDA tensors this launches the Hopper kernels
    of ``csrc/rel_attention_bwd.cu`` (counted once per call in
    ``rel_attention_backward.launches``); on CPU tensors it runs the plain
    version.  Any other device raises."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    _check_heads("rel_attention_bwd", BH, H)
    _check("rel_attention_bwd", [q_u, q_v, k, v, p, out, dout],
           [(BH, T, dk)] * 4 + [(H, 2 * T - 1, dk)] + [(BH, T, dk)] * 2)
    kv_len = _check_kv_len("rel_attention_bwd", kv_len, BH, q_u.device)
    if lse.shape != (BH, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("rel_attention_bwd: lse must be contiguous (BH, T) "
                         "float32")
    if not _device_path("rel_attention_bwd", q_u.device):
        return rel_attention_backward_reference(q_u, q_v, k, v, p, kv_len,
                                                out, lse, dout)
    _check_kernel_width("rel_attention_bwd", dk)
    grads = [torch.empty_like(x) for x in (q_u, q_v, k, v, p)]
    nqt = -(-T // TILE)
    delta = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    part = torch.empty((BH, nqt, TILE * (nqt + 1), dk), dtype=torch.float32,
                       device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch("rel_attention_bwd",
            _bind("rel_attention_bwd", "lasr_rel_attention_bwd", 16, 5),
            _ptr(q_u), _ptr(q_v), _ptr(k), _ptr(v), _ptr(p), _ptr(kv_len),
            _ptr(out), _ptr(lse), _ptr(dout), _ptr(delta), _ptr(part),
            *[_ptr(g) for g in grads], BH, T, dk, H,
            int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    rel_attention_backward.launches += 1
    return tuple(grads)


rel_attention_backward.launches = 0


class _RelAttentionContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, kv_len):
        out, lse = rel_attention_forward(q_u, q_v, k, v, p, kv_len)
        ctx.save_for_backward(q_u, q_v, k, v, p, kv_len, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q_u, q_v, k, v, p, kv_len, out, lse = ctx.saved_tensors
        grads = rel_attention_backward(q_u, q_v, k, v, p, kv_len, out, lse,
                                       dout.to(q_u.dtype).contiguous())
        return (*grads, None)


def rel_attention_context(q_u, q_v, k, v, p, kv_len):
    """Rel-pos attention context (BH, T, dk) with a gradient:
    ``rel_attention_forward`` forward, ``rel_attention_backward`` backward
    (``lasr_tpu/ops/rel_attention.py:rel_attention_context``).  ``kv_len``
    gets no gradient."""
    return _RelAttentionContext.apply(q_u, q_v, k, v, p, kv_len)
