"""Fused rotated-fold rel-pos attention: the CUDA kernel and its plain
version.

Counterpart of ``lasr_tpu/ops/rot_attention.py``.  The rotated fold
(``modules/attention.py`` ``_rot_fold_attend``) scores
``scores[i,j] = q_u[i]·k[j] + u[i]·V[j]`` with ``u`` the per-query rotated
position-query and ``V`` the static swapped-sinusoid table; the kernel
(``csrc/rot_attention.cu``) runs it flash-style, so the (B, H, T, T) score
tensor never reaches device memory.  Forward only: the backward (K2 of
the TPU package) belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lasr_tpu_torch.ops import cuda_build


def rot_attention_reference(q_u, u, k, v, vt, kv_len):
    """Plain PyTorch version of the kernel (the blockless math of
    ``lasr_tpu/ops/rot_attention.py:_xla_reference``), in f32.

    q_u/k/v: (BH, T, dk); u: (BH, T, M); vt: (T, M); kv_len: (BH,).
    Returns (out (BH, T, dk) in q_u's dtype, lse (BH, T) f32).  Rows with
    kv_len == 0 give zeros and lse = +inf."""
    BH, T, dk = q_u.shape
    s = (q_u.float() @ k.float().transpose(1, 2)
         + u.float() @ vt.float().t()) / math.sqrt(dk)
    mask = (torch.arange(T, device=s.device)[None, None, :]
            < kv_len.to(s.device)[:, None, None])
    return _masked_softmax_context(s, mask, v, q_u.dtype)


def _masked_softmax_context(s, mask, v, dtype):
    s = s.masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    a = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    out = (a @ v.float()).to(dtype)
    lse = torch.where(mask.any(dim=-1), lse, math.inf)
    return out, lse


def _check(name, tensors, shapes):
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: inputs must be float32 or bfloat16, got {dt}")
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{name}: inputs must share one device and dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    lib = cuda_build.library("rot_attention")
    fn = lib.lasr_rot_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rot_attention_forward(q_u, u, k, v, vt, kv_len):
    """Rotated-fold attention context and log-sum-exp.

    Shapes as ``rot_attention_reference``; kv_len is int32.  On CUDA
    tensors this launches the Hopper kernel (and counts the launch in
    ``rot_attention_forward.launches``); on CPU tensors it runs the plain
    version.  Any other device raises."""
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    _check("rot_attention", [q_u, u, k, v, vt],
           [(BH, T, dk), (BH, T, M), (BH, T, dk), (BH, T, dk), (T, M)])
    if kv_len.shape != (BH,) or kv_len.dtype != torch.int32 \
            or kv_len.device != q_u.device:
        raise ValueError("rot_attention: kv_len must be (BH,) int32 on the "
                         "inputs' device")
    if q_u.device.type == "cpu":
        return rot_attention_reference(q_u, u, k, v, vt, kv_len)
    if q_u.device.type != "cuda":
        raise RuntimeError(f"rot_attention: no kernel for {q_u.device}")
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    rc = _lib()(_ptr(q_u), _ptr(u), _ptr(k), _ptr(v), _ptr(vt), _ptr(kv_len),
                _ptr(out), _ptr(lse), BH, T, dk, M,
                int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rot_attention kernel launch failed: CUDA error "
                           f"{rc}")
    rot_attention_forward.launches += 1
    return out, lse


rot_attention_forward.launches = 0
