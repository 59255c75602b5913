"""Fused rotated-fold rel-pos attention: the CUDA kernels, their plain
versions and the autograd Function over them.

Counterpart of ``lasr_tpu/ops/rot_attention.py``.  The rotated fold
(``modules/attention.py`` ``_rot_fold_attend``) scores
``scores[i,j] = q_u[i]·k[j] + u[i]·V[j]`` with ``u`` the per-query rotated
position-query and ``V`` the static swapped-sinusoid table.  The forward
kernel (``csrc/rot_attention.cu``) runs it flash-style, so the (B, H, T, T)
score tensor never reaches device memory; the backward kernel
(``csrc/rot_attention_bwd.cu``) recomputes the probabilities from the
forward's ``lse``.  ``rot_attention_context`` pairs them in a
``torch.autograd.Function``, as the JAX package's ``custom_vjp`` does.
Each kernel has two forms: the narrow one keeps a block's 32 rows of
``[q_u ; u]`` resident and takes dk <= 64 where its tiles fit a block's
shared memory (the recipe: dk = 40, M = 320); the wide one streams S's
depth in chunks of 128 columns and takes any dk <= 128 and any M (the 1B
config: dk = 80, M = 1280).  ``rot_kernel_wide`` picks the form; dk > 128
raises ``ValueError`` before any launch (``check_rot_kernel_shape``).  In
bf16 the wide form runs on Hopper's wgmma and TMA
(``csrc/rot_attention_sm90.cu``, ``csrc/rot_attention_bwd_sm90.cu``:
``rot_attention_forward_wgmma``, ``rot_attention_backward_wgmma``) where
TMA can describe the tensors: dk and M multiples of 8 and 16-byte-aligned
bases (``rot_kernel_form``); other wide shapes, and f32, keep the wide
form above.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lasr_tpu_torch.ops import cuda_build


def rot_attention_reference(q_u, u, k, v, vt, kv_len):
    """Plain PyTorch version of the kernel (the blockless math of
    ``lasr_tpu/ops/rot_attention.py:_xla_reference``), in f32; on bf16
    inputs P is rounded to bf16 before P·v, as the kernels round it.

    q_u/k/v: (BH, T, dk); u: (BH, T, M); vt: (T, M); kv_len: (BH,).
    Returns (out (BH, T, dk) in q_u's dtype, lse (BH, T) f32).  Rows with
    kv_len == 0 give zeros and lse = +inf."""
    BH, T, dk = q_u.shape
    s = (q_u.float() @ k.float().transpose(1, 2)
         + u.float() @ vt.float().t()) / math.sqrt(dk)
    return _masked_softmax_context(s, _key_mask(kv_len, T, s.device), v,
                                   q_u.dtype)


def _key_mask(kv_len, T, device):
    return (torch.arange(T, device=device)[None, None, :]
            < kv_len.to(device)[:, None, None])


def _masked_softmax_context(s, mask, v, dtype):
    """softmax(s) @ v over the valid keys, and the rows' lse.  In bf16 the
    forward kernels (the Pallas ones and the port's) round P = exp(s - m),
    m the row's running maximum, to bf16 before P·v and divide by the sum
    of the unrounded P; here m is the row maximum (the kernels' value when
    one key tile covers the row)."""
    s = s.masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    if dtype == torch.float32:
        a = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        out = a @ v.float()
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - torch.where(
            torch.isfinite(m), m, 0.0)), 0.0)
        out = (e.to(dtype).float() @ v.float()) \
            / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    lse = torch.where(mask.any(dim=-1), lse, math.inf)
    return out.to(dtype), lse


def _probs_and_score_grad(s, mask, lse, v, out, dout, dk):
    """P = exp(s - lse) on valid keys, and dz = P * (dout·v - delta) /
    sqrt(dk) with delta = dout·out (f32).  Rows with lse = +inf (kv_len ==
    0) give exact zeros."""
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dout = dout.float()
    delta = (dout * out.float()).sum(-1)
    dz = p * (dout @ v.float().transpose(1, 2) - delta[..., None]) \
        / math.sqrt(dk)
    return p, dz


def rot_attention_backward_reference(q_u, u, k, v, vt, kv_len, out, lse,
                                     dout):
    """Plain PyTorch version of the backward kernel (the math of
    ``lasr_tpu/ops/rot_attention.py:_bwd_kernel``), in f32, from the
    forward's ``out`` and ``lse``.  On bf16 inputs dz is rounded to bf16
    before its three products, as the Pallas kernel rounds it (P stays
    f32 in P^T·dout there too).

    Returns (dq_u, du, dk, dv) in the dtypes of q_u, u, k, v; vt (the
    static table) gets no gradient."""
    BH, T, dk = q_u.shape
    s = (q_u.float() @ k.float().transpose(1, 2)
         + u.float() @ vt.float().t()) / math.sqrt(dk)
    p, dz = _probs_and_score_grad(s, _key_mask(kv_len, T, s.device), lse,
                                  v, out, dout, dk)
    dz = dz.to(q_u.dtype).float()
    return ((dz @ k.float()).to(q_u.dtype), (dz @ vt.float()).to(u.dtype),
            (dz.transpose(1, 2) @ q_u.float()).to(k.dtype),
            (p.transpose(1, 2) @ dout.float()).to(v.dtype))


# the widest head the kernels take (csrc/rot_attention*.cu's DK_MAX), and
# the narrow form's (DK_NARROW)
ROT_DK_MAX = 128
ROT_DK_NARROW = 64
# an H100's shared memory for one block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_PER_BLOCK = 232448


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _narrow_smem_bytes(dk: int, M: int, backward: bool) -> int:
    """The least dynamic shared memory of a narrow K1 (forward) or K2
    (backward) block: one buffer of the streamed tile, tiles through
    registers (the kernels' fallback; ``smem_bytes`` of
    csrc/rot_attention*.cu)."""
    BQ = BK = 32
    LS = BK + 4
    LQ, LD = _ceil16(dk + M) + 4, _ceil16(dk) + 4
    if backward:
        floats = 2 * BQ * (LQ + LD) + 3 * BQ * LS + 4 * BQ
    else:
        floats = BQ * LQ + BK * (LQ + LD) + 9 * BQ * LS + BQ * LD + 2 * BQ
    return 4 * floats


def _wide_smem_bytes(dk: int, backward: bool) -> int:
    """A wide block's dynamic shared memory in f32 (bf16 takes less),
    whatever M: ``wide_smem_bytes`` of csrc/rot_attention.cu, the larger
    of ``wide_key_smem_bytes`` / ``wide_query_smem_bytes`` of
    csrc/rot_attention_bwd.cu."""
    BQ = BK = 32
    LS, LC, NST, NWARPS = BK + 4, 128 + 4, 3, 8
    LD = _ceil16(dk) + 4
    if backward:
        key = NST * ((BQ + BK) * LC + BQ * LD) + 2 * NST * BQ + BK * LD \
            + (NWARPS + 2) * BQ * LS
        query = 2 * BK * (24 * 16 + 4) + 2 * BQ * LS
        return 4 * max(key, query)
    return 4 * (NST * ((BQ + BK) * LC + BK * LD) + (NWARPS + 1) * BQ * LS
                + 2 * BQ)


def rot_kernel_wide(dk: int, M: int, backward: bool,
                    smem_limit: int = SMEM_PER_BLOCK) -> bool:
    """True where K1 (forward) / K2 (backward) take their wide form: dk >
    64, or narrow tiles that do not fit ``smem_limit`` bytes (at the 1B
    config's dk = 80, M = 1280 a narrow K1 block needs 412 KB)."""
    return dk > ROT_DK_NARROW \
        or _narrow_smem_bytes(dk, M, backward) > smem_limit


def wgmma_describable(dk: int, M: int) -> bool:
    """True where the wgmma forms' tensor maps describe q_u / k / v (rows
    of dk bf16) and u / V (rows of M): rows of a multiple of 16 bytes, and
    dk within the kernels' two 64-column boxes."""
    return 8 <= dk <= ROT_DK_MAX and dk % 8 == 0 and M >= 8 and M % 8 == 0


def rot_kernel_form(dk: int, M: int, dtype, backward: bool,
                    aligned: bool = True,
                    smem_limit: int = SMEM_PER_BLOCK) -> str:
    """Which K1 (forward) / K2 (backward) kernel runs at (dk, M):
    "narrow", "wide" (f32, or bf16 that TMA cannot describe) or
    "wgmma" (bf16 where the wide form holds, ``wgmma_describable`` and
    ``aligned``: every tensor's base 16-byte aligned)."""
    if not rot_kernel_wide(dk, M, backward, smem_limit):
        return "narrow"
    if dtype == torch.bfloat16 and aligned and wgmma_describable(dk, M):
        return "wgmma"
    return "wide"


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def rot_kernel_smem_bytes(dk: int, M: int, backward: bool,
                          smem_limit: int = SMEM_PER_BLOCK) -> int:
    """The least dynamic shared memory of the K1 / K2 block that runs at
    (dk, M): the narrow form's, or the wide form's (which does not grow
    with M)."""
    if rot_kernel_wide(dk, M, backward, smem_limit):
        return _wide_smem_bytes(dk, backward)
    return _narrow_smem_bytes(dk, M, backward)


def check_rot_kernel_shape(name: str, dk: int, M: int, backward: bool,
                           smem_limit: int = SMEM_PER_BLOCK) -> None:
    """Before a K1 / K2 launch: raise ``ValueError`` for dk > 128, or for a
    card whose ``smem_limit`` bytes of shared memory a block cannot hold
    the wide form's tiles (never on an H100: at most 215,808 B)."""
    if dk > ROT_DK_MAX:
        raise ValueError(f"{name}: the kernel takes head widths up to "
                         f"{ROT_DK_MAX}, got dk={dk}")
    need = rot_kernel_smem_bytes(dk, M, backward, smem_limit)
    if need > smem_limit:
        raise ValueError(f"{name}: dk={dk} needs {need} bytes of shared "
                         f"memory a block, over the card's {smem_limit}")


def _smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_PER_BLOCK))


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


def _bind(source, symbol, n_ptr, n_int):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``: n_ptr pointers,
    n_int ints, then the stream; returns a cudaError_t code."""
    fn = getattr(cuda_build.library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_kv_len(name, kv_len, BH, device):
    if kv_len.shape != (BH,) or kv_len.dtype != torch.int32 \
            or kv_len.device != device:
        raise ValueError(f"{name}: kv_len must be (BH,) int32 on the "
                         f"inputs' device")
    return kv_len.contiguous()


def _device_path(name, device) -> bool:
    """True for CUDA (launch the kernel), False for the CPU (the plain
    version); any other device raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {device}")
    return True


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def rot_attention_forward(q_u, u, k, v, vt, kv_len):
    """Rotated-fold attention context and log-sum-exp.

    Shapes as ``rot_attention_reference``; kv_len is int32.  On CUDA
    tensors this launches the Hopper kernel (and counts the launch in
    ``rot_attention_forward.launches``); on CPU tensors it runs the plain
    version.  Any other device raises; on CUDA, dk > 128 raises
    ``ValueError`` before the launch (``check_rot_kernel_shape``)."""
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    _check("rot_attention", [q_u, u, k, v, vt],
           [(BH, T, dk), (BH, T, M), (BH, T, dk), (BH, T, dk), (T, M)])
    kv_len = _check_kv_len("rot_attention", kv_len, BH, q_u.device)
    if not _device_path("rot_attention", q_u.device):
        return rot_attention_reference(q_u, u, k, v, vt, kv_len)
    smem = _smem_limit(q_u.device)
    check_rot_kernel_shape("rot_attention", dk, M, False, smem)
    form = rot_kernel_form(dk, M, q_u.dtype, False,
                           _aligned16(q_u, u, k, v, vt), smem)
    if form == "wgmma":
        out, lse = rot_attention_forward_wgmma(q_u, u, k, v, vt, kv_len)
        rot_attention_forward.launches += 1
        return out, lse
    symbol = "lasr_rot_attention_fwd" + ("_wide" if form == "wide" else "")
    out = torch.empty_like(q_u)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch("rot_attention", _bind("rot_attention", symbol, 8, 5),
            _ptr(q_u), _ptr(u), _ptr(k), _ptr(v), _ptr(vt), _ptr(kv_len),
            _ptr(out), _ptr(lse), BH, T, dk, M,
            int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    rot_attention_forward.launches += 1
    return out, lse


rot_attention_forward.launches = 0


def rot_attention_backward(q_u, u, k, v, vt, kv_len, out, lse, dout):
    """Gradients (dq_u, du, dk, dv) of ``rot_attention_forward``'s output.

    ``out`` and ``lse`` are the forward's, ``dout`` the output's gradient
    (the inputs' dtype).  On CUDA tensors this launches the Hopper kernels
    of ``csrc/rot_attention_bwd.cu`` (counted once per call in
    ``rot_attention_backward.launches``; the wide form writes dz into an
    f32 scratch); on CPU tensors it runs the plain version.  Any other
    device raises; on CUDA, dk > 128 raises ``ValueError`` before the
    launch."""
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    _check("rot_attention_bwd", [q_u, u, k, v, vt, out, dout],
           [(BH, T, dk), (BH, T, M), (BH, T, dk), (BH, T, dk), (T, M),
            (BH, T, dk), (BH, T, dk)])
    kv_len = _check_kv_len("rot_attention_bwd", kv_len, BH, q_u.device)
    if lse.shape != (BH, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("rot_attention_bwd: lse must be contiguous (BH, T) "
                         "float32")
    if not _device_path("rot_attention_bwd", q_u.device):
        return rot_attention_backward_reference(q_u, u, k, v, vt, kv_len,
                                                out, lse, dout)
    smem = _smem_limit(q_u.device)
    check_rot_kernel_shape("rot_attention_bwd", dk, M, True, smem)
    form = rot_kernel_form(dk, M, q_u.dtype, True,
                           _aligned16(q_u, u, k, v, vt, dout), smem)
    if form == "wgmma":
        grads = rot_attention_backward_wgmma(q_u, u, k, v, vt, kv_len, out,
                                             lse, dout)
        rot_attention_backward.launches += 1
        return grads
    dq_u, du, dk_, dv = (torch.empty_like(q_u), torch.empty_like(u),
                         torch.empty_like(k), torch.empty_like(v))
    delta = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    ptrs = [_ptr(x) for x in (q_u, u, k, v, vt, kv_len, out, lse, dout,
                              delta, dq_u, du, dk_, dv)]
    symbol = "lasr_rot_attention_bwd"
    if form == "wide":
        # the wide form's dz, written once by its key pass: (BH, T32, T32)
        # f32, T32 = T rounded up to 32 (354 MB at the 1B training shape)
        symbol += "_wide"
        T32 = -(-T // 32) * 32
        dz = torch.empty((BH, T32, T32), dtype=torch.float32,
                         device=q_u.device)
        ptrs.append(_ptr(dz))
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch("rot_attention_bwd",
            _bind("rot_attention_bwd", symbol, len(ptrs), 5), *ptrs, BH, T,
            dk, M, int(q_u.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    rot_attention_backward.launches += 1
    return dq_u, du, dk_, dv


rot_attention_backward.launches = 0


def _check_wgmma(name, dk, M, tensors):
    """Before a wgmma form's launch: bf16 CUDA inputs that TMA can
    describe, else ``ValueError``."""
    if tensors[0].dtype != torch.bfloat16:
        raise ValueError(f"{name}: the wgmma form takes bfloat16 inputs, "
                         f"got {tensors[0].dtype}")
    if not wgmma_describable(dk, M):
        raise ValueError(f"{name}: the wgmma form takes dk <= {ROT_DK_MAX} "
                         f"and dk, M multiples of 8, got dk={dk}, M={M}")
    if not _aligned16(*tensors):
        raise ValueError(f"{name}: the wgmma form's tensors must start on "
                         f"16-byte boundaries")
    if not _device_path(name, tensors[0].device):
        raise ValueError(f"{name}: the wgmma form takes CUDA tensors "
                         f"(rot_attention_forward / _backward run the "
                         f"plain version on the CPU)")


def rot_attention_forward_wgmma(q_u, u, k, v, vt, kv_len):
    """K1's bf16 wide form on Hopper's wgmma and TMA
    (``csrc/rot_attention_sm90.cu``): the launch that
    ``rot_attention_forward`` makes for ``rot_kernel_form`` "wgmma",
    after its shape, kv_len and device checks; callable at any dk it
    takes on CUDA tensors that pass those checks, as the card's tests do.
    bf16 only, dk <= 128 and dk, M multiples of 8, 16-byte-aligned
    tensors, else ``ValueError`` before a launch.  Counted in
    ``rot_attention_forward_wgmma.launches``."""
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    name = "rot_attention_wgmma"
    _check_wgmma(name, dk, M, [q_u, u, k, v, vt])
    out = torch.empty_like(q_u)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch(name, _bind("rot_attention_sm90", "lasr_rot_attention_fwd_wgmma",
                        8, 4),
            _ptr(q_u), _ptr(u), _ptr(k), _ptr(v), _ptr(vt), _ptr(kv_len),
            _ptr(out), _ptr(lse), BH, T, dk, M, ctypes.c_void_p(stream))
    rot_attention_forward_wgmma.launches += 1
    return out, lse


rot_attention_forward_wgmma.launches = 0


def rot_attention_backward_wgmma(q_u, u, k, v, vt, kv_len, out, lse, dout):
    """K2's bf16 wide form on Hopper's wgmma and TMA
    (``csrc/rot_attention_bwd_sm90.cu``: delta, the key pass, the query
    pass): the launch that ``rot_attention_backward`` makes for
    ``rot_kernel_form`` "wgmma", after its checks; arguments, results and
    refusals as ``rot_attention_backward`` and
    ``rot_attention_forward_wgmma``.  dz goes through a (BH, T, T8) bf16
    scratch (dz^T, T8 = T rounded up to 8: 156 MB at the 1B training
    shape).  Counted in ``rot_attention_backward_wgmma.launches``."""
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    name = "rot_attention_bwd_wgmma"
    _check_wgmma(name, dk, M, [q_u, u, k, v, vt, dout])
    dq_u, du, dk_, dv = (torch.empty_like(q_u), torch.empty_like(u),
                         torch.empty_like(k), torch.empty_like(v))
    delta = torch.empty((BH, T), dtype=torch.float32, device=q_u.device)
    dzt = torch.empty((BH, T, -(-T // 8) * 8), dtype=torch.bfloat16,
                      device=q_u.device)
    ptrs = [_ptr(x) for x in (q_u, u, k, v, vt, kv_len, out, lse, dout,
                              delta, dq_u, du, dk_, dv, dzt)]
    stream = torch.cuda.current_stream(q_u.device).cuda_stream
    _launch(name, _bind("rot_attention_bwd_sm90",
                        "lasr_rot_attention_bwd_wgmma", len(ptrs), 4),
            *ptrs, BH, T, dk, M, ctypes.c_void_p(stream))
    rot_attention_backward_wgmma.launches += 1
    return dq_u, du, dk_, dv


rot_attention_backward_wgmma.launches = 0


class _RotAttentionContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, u, k, v, vt, kv_len):
        out, lse = rot_attention_forward(q_u, u, k, v, vt, kv_len)
        ctx.save_for_backward(q_u, u, k, v, vt, kv_len, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q_u, u, k, v, vt, kv_len, out, lse = ctx.saved_tensors
        dq_u, du, dk, dv = rot_attention_backward(
            q_u, u, k, v, vt, kv_len, out, lse,
            dout.to(q_u.dtype).contiguous())
        return dq_u, du, dk, dv, None, None


def rot_attention_context(q_u, u, k, v, vt, kv_len):
    """Rotated-fold attention context (BH, T, dk) with a gradient:
    ``rot_attention_forward`` forward, ``rot_attention_backward`` backward
    (``lasr_tpu/ops/rot_attention.py:rot_attention_context``).  ``vt`` and
    ``kv_len`` get no gradient."""
    return _RotAttentionContext.apply(q_u, u, k, v, vt, kv_len)
