"""Fused relative-position attention: the CUDA kernel and its plain version.

Counterpart of ``lasr_tpu/ops/rel_attention.py``: computes
``softmax_j[(q_u·k_j + q_v·p_{T-1-i+j}) / sqrt(dk) + mask] @ v``
flash-style (``csrc/rel_attention.cu``), never materializing the score
matrix; the rel-shift is an index remap over a window of ``p`` staged in
shared memory.  Forward only: the backward (K4 of the TPU package) belongs
to the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lasr_tpu_torch.ops import cuda_build
from lasr_tpu_torch.ops.rot_attention import (
    _check, _masked_softmax_context, _ptr)


def rel_attention_reference(q_u, q_v, k, v, p, kv_len):
    """Plain PyTorch version of the kernel (the blockless math of
    ``lasr_tpu/ops/rel_attention.py:_xla_reference``), in f32.

    q_u/q_v/k/v: (BH, T, dk) with bh = b*H + h; p: (H, 2T-1, dk) shared
    across the batch; kv_len: (BH,).  Returns (out (BH, T, dk), lse
    (BH, T) f32); rows with kv_len == 0 give zeros and lse = +inf."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    ac = q_u.float() @ k.float().transpose(1, 2)
    w = (q_v.float().reshape(BH // H, H, T, dk)
         @ p.float().transpose(1, 2)[None]).reshape(BH, T, 2 * T - 1)
    # rel shift: bd[i, j] = w[i, T-1-i+j]
    idx = (T - 1 - torch.arange(T, device=w.device)[:, None]
           + torch.arange(T, device=w.device)[None, :])
    bd = torch.gather(w, 2, idx[None].expand(BH, T, T))
    s = (ac + bd) / math.sqrt(dk)
    mask = (torch.arange(T, device=s.device)[None, None, :]
            < kv_len.to(s.device)[:, None, None])
    return _masked_softmax_context(s, mask, v, q_u.dtype)


def _lib():
    fn = cuda_build.library("rel_attention").lasr_rel_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rel_attention_forward(q_u, q_v, k, v, p, kv_len):
    """Rel-pos attention context and log-sum-exp.

    Shapes as ``rel_attention_reference``; kv_len is int32.  On CUDA
    tensors this launches the Hopper kernel (counted in
    ``rel_attention_forward.launches``); on CPU tensors it runs the plain
    version.  Any other device raises."""
    BH, T, dk = q_u.shape
    H = p.shape[0]
    if H < 1 or BH % H:
        raise ValueError(f"rel_attention: BH={BH} is not a multiple of H={H}")
    _check("rel_attention", [q_u, q_v, k, v, p],
           [(BH, T, dk)] * 4 + [(H, 2 * T - 1, dk)])
    if kv_len.shape != (BH,) or kv_len.dtype != torch.int32 \
            or kv_len.device != q_u.device:
        raise ValueError("rel_attention: kv_len must be (BH,) int32 on the "
                         "inputs' device")
    if q_u.device.type == "cpu":
        return rel_attention_reference(q_u, q_v, k, v, p, kv_len)
    if q_u.device.type != "cuda":
        raise RuntimeError(f"rel_attention: no kernel for {q_u.device}")
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    rc = _lib()(_ptr(q_u), _ptr(q_v), _ptr(k), _ptr(v), _ptr(p), _ptr(kv_len),
                _ptr(out), _ptr(lse), BH, T, dk, H,
                int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rel_attention kernel launch failed: CUDA error "
                           f"{rc}")
    rel_attention_forward.launches += 1
    return out, lse


rel_attention_forward.launches = 0
