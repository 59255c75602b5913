"""Multi-head attention (counterpart of ``lasr_tpu/modules/attention.py``).

  - ``MultiHeadedAttention``: scaled-dot MHA with ``project_q`` /
    ``project_kv`` / ``attend``, so cached decode reuses the projections;
    dropout on the attention probabilities in train mode.
  - ``RelPositionMultiHeadedAttention``: Transformer-XL relative-position
    scoring with pos_bias_u/v, by the JAX module's paths in its order: the
    rel kernel (``use_pallas``); the rotated fold (eval, or training under
    ``rot_fold_train`` with positional dropout on ``u``), in plain PyTorch
    or through the rot kernel (``rot_fold_pallas``); the skewed-table fold
    (``pos_table``); the per-layer ``rel_shift``.  Both kernel paths run
    forward and backward kernels through autograd Functions.
  - ``MTMultiHeadedAttention``: monotonic truncated attention of the
    streaming decoder — sigmoid choose-probabilities times an exclusive
    survival cumprod, with a trainable scalar score bias
    (``src_att_bias``), training-time sigmoid noise (``sigmoid_noise`` ·
    N(0, 1) added to the scores, drawn by ``modules.dropout``'s
    generator), and the decode-step pieces: scores, endpoint advance,
    endpoint-truncated context.  It computes in the dtype of its inputs'
    projections, as ``lasr_tpu``'s does (bf16 scores, cumprod and all).

All masks are boolean with True = attendable.  (``remat_attend``, a TPU
memory knob of the JAX module, is accepted and ignored at the model,
``encoder_remat_attend``.)  Under tensor parallelism (``parallel.tensor``)
a module holds ``n_head`` of the model's heads, its model rank's part
(``head_shard``): every head-wise width is ``n_head * d_k``, and the
replicated ``pos_bias_u`` / ``pos_bias_v`` are sliced to those heads.
Where the model ranks do not divide the heads (the streaming decoder's
one-head monotonic attention, ``column_shard``) the projections split by
columns, cutting inside a head, as ``lasr_tpu``'s name rules split them:
the model ranks gather the projections' columns, compute the energies,
probabilities (and the sigmoid noise, from their shared generator) or a
kernel whole, and each feeds its columns of the context to its rows of
the row-parallel ``linear_out``.

Under sequence parallelism (``parallel.dist.seq_split``) a self-attention
gets the seq rank's rows of the time axis as queries: the keys and
values (and the mask's keys, which every rank holds whole) are gathered
over the seq ranks, the relative positions taken at the rank's offset;
with a kernel flag the kernel's operands are gathered, the kernel runs
over the whole sequence and the rank keeps its rows, the backward summing
the operands' gradients over the seq ranks.

``capture_attention()`` is the counterpart of the JAX modules' ``sow`` of
their probabilities into 'intermediates': inside the block, each module
whose forward computes its probabilities (the softmax paths and the
monotonic attention's forward) records the first (B, H, T1, T2) map of
the block, before dropout.  The rot kernel's fold then takes its plain
path, as the JAX fold leaves its Pallas kernel while intermediates are
harvested; the rel kernel (``use_pallas``) computes no probabilities and
records nothing, as in ``lasr_tpu``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.dropout import (dropout, standard_normal,
                                            time_shard)
from lasr_tpu_torch.modules.embedding import sinusoid_table
from lasr_tpu_torch.modules.layers import Linear
from lasr_tpu_torch.ops.rel_attention import rel_attention_context
from lasr_tpu_torch.ops.rot_attention import rot_attention_context
from lasr_tpu_torch.parallel import dist


_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "lasr_tpu_torch_attention_capture", default=None)


@contextlib.contextmanager
def capture_attention():
    """Yields {module: its first detached probability map} of the block."""
    maps = {}
    token = _CAPTURE.set(maps)
    try:
        yield maps
    finally:
        _CAPTURE.reset(token)


def _record(module: nn.Module, attn: torch.Tensor) -> None:
    maps = _CAPTURE.get()
    if maps is not None and module not in maps:
        maps[module] = attn.detach()


@functools.lru_cache(maxsize=8)
def _rot_tables(T: int, M: int):
    """Numpy constants of the rotated fold: W[i] carries sin/cos(ω_c·i)
    interleaved (= ``sinusoid_table``), V[j] the same with sin/cos swapped
    within each frequency pair."""
    W = sinusoid_table(T, M)
    V = np.empty_like(W)
    V[:, 0::2] = W[:, 1::2]
    V[:, 1::2] = W[:, 0::2]
    return W, V


def build_skewed_pos_table(pos_emb: torch.Tensor) -> torch.Tensor:
    """(1, 2T-1, M) relative table → (T, T, M) with out[i, j] =
    pos_emb[0, T-1-i+j]: the rel-shift index map on the batch-independent
    table, built once per encoder forward (``lasr_tpu``'s pad/reshape
    skew)."""
    e = pos_emb[0]
    P, M = e.shape
    T = (P + 1) // 2
    x = F.pad(e[None].expand(T, P, M), (0, 0, 1, 0))     # (T, P+1, M)
    x = x.reshape(P + 1, T, M)[1:].reshape(T, P, M)
    return x[:, :T]


def rel_shift(x: torch.Tensor, n_keys=None) -> torch.Tensor:
    """Transformer-XL relative shift: x (B, H, T1, P) scored against
    distances [T1-1 .. T1-P] → (B, H, T1, n_keys) with column j at
    distance i-j, out[i, j] = x[i, T1-1-i+j]; P = 2T1-1 and n_keys = T1
    by default (P = T1 + n_keys - 1 in general)."""
    B, H, T1, P = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, P + 1, T1)
    n_keys = P // 2 + 1 if n_keys is None else n_keys
    return x[:, :, 1:].reshape(B, H, T1, P)[..., :n_keys]


def _key_lengths(mask, B: int, T: int, H: int, device) -> torch.Tensor:
    """(B*H,) int32 key counts of a key-prefix padding mask (B, 1, T)
    (True = valid, padding trails); bh = b*H + h."""
    if mask is None:
        kv_len = torch.full((B,), T, dtype=torch.int32, device=device)
    else:
        kv_len = mask[:, 0, :].sum(dim=-1).to(torch.int32)
    return kv_len.repeat_interleave(H)


def _is_key_prefix_mask(mask) -> bool:
    return mask is None or (mask.ndim == 3 and mask.shape[1] == 1)


class MultiHeadedAttention(nn.Module):
    # (rank, size): the heads are this model rank's part; None when whole
    head_shard = None
    # (rank, size): the projections' columns are this model rank's part,
    # the heads whole (see the module docstring); None when unsplit
    column_shard = None

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} is not a multiple of n_head "
                             f"{n_head}")
        self.n_head, self.n_feat = n_head, n_feat
        self.d_k = n_feat // n_head
        self.dropout_rate = dropout_rate
        self.linear_q = Linear(n_feat, n_feat)
        self.linear_k = Linear(n_feat, n_feat)
        self.linear_v = Linear(n_feat, n_feat)
        self.linear_out = Linear(n_feat, n_feat)

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_head, self.d_k)

    @property
    def _width(self) -> int:
        """The heads' concatenated width (n_feat unless split)."""
        return self.n_head * self.d_k

    def _head_shard(self, dim: int):
        """``modules.dropout``'s ``shard`` for the heads dim ``dim``."""
        return None if self.head_shard is None else (dim, *self.head_shard)

    def _heads(self, b: torch.Tensor) -> torch.Tensor:
        """Rows of the (H, ...) parameter ``b`` of this module's heads."""
        return b if self.head_shard is None else dist.slice_replicated(b, 0)

    def _columns(self, x: torch.Tensor) -> torch.Tensor:
        """A projection's whole width under a column split (its columns
        gathered over the model ranks); ``x`` itself otherwise."""
        return x if self.column_shard is None else dist.gather_from_model(x)

    def _project_out(self, x: torch.Tensor) -> torch.Tensor:
        """linear_out of the concatenated heads; under a column split the
        model ranks' whole contexts enter through ``copy_to_model`` (so
        each computes the whole gradient of the replicated part) and each
        keeps its columns."""
        if self.column_shard is not None:
            r, n = self.column_shard
            w = x.shape[-1] // n
            x = dist.copy_to_model(x).narrow(-1, r * w, w)
        return self.linear_out(x)

    def _seq_keys(self, k, v):
        """Keys and values (B, T, H, dk) of the whole sequence under a
        seq split (gathered over the seq ranks)."""
        if dist.current_seq_split() is None:
            return k, v
        return dist.seq_gather(k, 1), dist.seq_gather(v, 1)

    def project_q(self, query):
        return self._split(self._columns(self.linear_q(query)))

    def project_kv(self, key, value):
        return (self._split(self._columns(self.linear_k(key))),
                self._split(self._columns(self.linear_v(value))))

    def _softmax_attend(self, scores, v, mask):
        """scores: (B, H, T1, T2); v: (B, T2, H, dk); mask broadcastable to
        (B, 1|H, T1|1, T2) boolean."""
        if mask is not None:
            while mask.ndim < scores.ndim:
                mask = mask[:, None] if mask.ndim == 3 else mask[None]
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
            # the second fill matters only for fully-masked rows (batch
            # padding), which would otherwise attend uniformly
            attn = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
        else:
            attn = torch.softmax(scores, dim=-1)
        _record(self, attn)
        attn = dropout(attn, self.dropout_rate, self.training,
                       (self._head_shard(1), time_shard(2)))
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        B, T1 = x.shape[:2]
        return self._project_out(x.reshape(B, T1, self._width))

    def attend(self, q, k, v, mask=None):
        """q: (B, T1, H, dk); k/v: (B, T2, H, dk)."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        return self._softmax_attend(scores, v, mask)

    def forward(self, query, key, value, mask=None):
        q = self.project_q(query)
        k, v = self._seq_keys(*self.project_kv(key, value))
        return self.attend(q, k, v, mask)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """``use_pallas``: the rel kernel, whenever attention dropout is off
    in training, the mask is a key-prefix padding mask and the table is
    the shared (1, 2T-1, D) one.  ``rot_fold``: merge content and position
    scores into one product over dk+M lanes via the sinusoid
    angle-addition identity (valid for the unclamped sinusoid table the
    conformer encoder owns), in eval and, with ``rot_fold_train``, in
    training with dropout at ``pos_dropout_rate`` on the rotated
    position-query ``u``.  ``rot_fold_pallas``: run that fold through the
    rot kernel."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 zero_triu: bool = False, use_pallas: bool = False,
                 rot_fold: bool = False, rot_fold_pallas: bool = False,
                 rot_fold_train: bool = False, pos_dropout_rate: float = 0.0):
        super().__init__(n_head, n_feat, dropout_rate)
        self.zero_triu = zero_triu
        self.use_pallas = use_pallas
        self.rot_fold = rot_fold
        self.rot_fold_pallas = rot_fold_pallas
        self.rot_fold_train = rot_fold_train
        self.pos_dropout_rate = pos_dropout_rate
        self.linear_pos = Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def _kernel_ok(self, mask) -> bool:
        """The kernels fuse the softmax, so attention dropout rules them
        out in training."""
        return (_is_key_prefix_mask(mask)
                and (not self.training or self.dropout_rate == 0.0))

    def _heads_major(self, x):
        """(B, T, H, e) → contiguous (B*H, T, e), bh = b*H + h."""
        B, T, H, e = x.shape
        return x.permute(0, 2, 1, 3).reshape(B * H, T, e).contiguous()

    def _from_heads_major(self, ctx, B, T):
        ctx = ctx.reshape(B, self.n_head, T, self.d_k).permute(0, 2, 1, 3)
        return self._project_out(ctx.reshape(B, T, self._width))

    def _pos_kernel(self):
        """linear_pos as (M, H, dk): contracted into the query side."""
        return self._columns(self.linear_pos.weight.t()).reshape(
            self.n_feat, self.n_head, self.d_k)

    def _kernel_rows(self, kernel, qs, kv, B, T, mask):
        """``kernel(*heads-major operands, kv_len)`` → the context of the
        query rows (B, T, ·) through linear_out.  ``qs`` are query-side
        operands (B, T, H, e), ``kv`` the keys and values; under a seq
        split the query side is gathered (keys and values come whole) and
        the rank keeps its rows of the whole sequence's context."""
        split = dist.current_seq_split()
        n = T if split is None else split.length
        if split is not None:
            qs = [dist.seq_gather(q, 1) for q in qs]
        hm = self._heads_major
        ctx = kernel(*[hm(x) for x in qs + kv],
                     _key_lengths(mask, B, n, self.n_head, kv[0].device))
        if split is not None:
            ctx = ctx.narrow(1, split.offset, T)
        return self._from_heads_major(ctx, B, T)

    def _rel_kernel_attend(self, query, key, value, pos_emb, mask):
        B, T, _ = query.shape
        q = self.project_q(query)
        k, v = self._seq_keys(*self.project_kv(key, value))
        p = self._split(self._columns(self.linear_pos(pos_emb)))[0]
        q_u = q + self._heads(self.pos_bias_u).to(q.dtype)
        q_v = q + self._heads(self.pos_bias_v).to(q.dtype)
        pt = p.permute(1, 0, 2).contiguous()               # (H, 2T-1, dk)
        return self._kernel_rows(
            lambda qu, qv, kk, vv, kv_len: rel_attention_context(
                qu, qv, kk, vv, pt, kv_len),
            [q_u, q_v], [k, v], B, T, mask)

    def _rot_fold_attend(self, q_u, q_v, k, v, mask):
        """``bd[i,j] = q_v_i · p(i−j)`` decomposes exactly as ``u_i · V_j``
        with ``u = rot_i(q_v @ W_pos)`` a per-query 2x2 rotation per
        frequency pair, so scores = [q_u ; u] @ [k ; V]^T / sqrt(dk).
        ``k`` / ``v`` span the whole sequence (its ``n`` frames); the
        queries are the rows from the seq split's offset."""
        B, T = q_u.shape[:2]
        n = k.shape[1]
        split = dist.current_seq_split()
        off = 0 if split is None else split.offset
        M, H, dk = self.n_feat, self.n_head, self.d_k
        z = torch.einsum("bqhd,mhd->bqhm", q_v,
                         self._pos_kernel().to(q_v.dtype))  # (B, T, H, M)
        W, V = _rot_tables(n, M)
        W = torch.from_numpy(W[off:off + T]).to(z.device, z.dtype)
        si = W[None, :, None, 0::2]
        ci = W[None, :, None, 1::2]
        zs, zc = z[..., 0::2], z[..., 1::2]
        u = torch.stack([zs * si + zc * ci, zc * si - zs * ci],
                        dim=-1).reshape(z.shape)
        if self.rot_fold_train:
            # rotated-space positional dropout (training only)
            u = dropout(u, self.pos_dropout_rate, self.training,
                        (self._head_shard(2), time_shard(1)))
        vt = torch.from_numpy(V).to(k.device, k.dtype)     # (n, M)
        if self.rot_fold_pallas and self._kernel_ok(mask) \
                and _CAPTURE.get() is None:
            return self._kernel_rows(
                lambda qu, uu, kk, vv, kv_len: rot_attention_context(
                    qu, uu, kk, vv, vt, kv_len),
                [q_u, u], [k, v], B, T, mask)
        qcat = torch.cat([q_u, u], dim=-1)                 # (B, T, H, dk+M)
        kcat = torch.cat([k, vt[None, :, None, :].expand(B, n, H, M)], dim=-1)
        scores = torch.einsum("bqhe,bkhe->bhqk", qcat, kcat) / math.sqrt(dk)
        return self._softmax_attend(scores, v, mask)

    def forward(self, query, key, value, pos_emb, mask=None, pos_table=None):
        """``pos_table``: the (T, T, M) table of ``build_skewed_pos_table``;
        when given (self-attention, T1 == T2), the position score is
        ``(q_v @ W_pos)[b,h,i,:] · pos_table[i,j,:]``, the same rel-shift
        contraction with the shift on the shared table."""
        T1, T2 = query.shape[1], key.shape[1]
        split = dist.current_seq_split()
        # the whole sequence's frames, and the query rows' first
        n, off = (T1, 0) if split is None else (split.length, split.offset)
        shared_table = (pos_emb is not None and pos_emb.shape[0] == 1
                        and pos_emb.shape[1] == 2 * n - 1)
        square = not self.zero_triu and T1 == T2
        if self.use_pallas and square and shared_table \
                and self._kernel_ok(mask):
            return self._rel_kernel_attend(query, key, value, pos_emb, mask)
        q = self.project_q(query)
        k, v = self._seq_keys(*self.project_kv(key, value))
        T2 = k.shape[1]
        q_u = q + self._heads(self.pos_bias_u).to(q.dtype)
        q_v = q + self._heads(self.pos_bias_v).to(q.dtype)
        if (self.rot_fold and (not self.training or self.rot_fold_train)
                and square and shared_table):
            return self._rot_fold_attend(q_u, q_v, k, v, mask)
        ac = torch.einsum("bqhd,bkhd->bhqk", q_u, k)
        if pos_table is not None and square and pos_table.shape[0] == n:
            z = torch.einsum("bqhd,mhd->bhqm", q_v,
                             self._pos_kernel().to(q_v.dtype))
            bd = torch.einsum("bhqm,qkm->bhqk", z,
                              pos_table[off:off + T1].to(z.dtype))
            return self._softmax_attend((ac + bd) / math.sqrt(self.d_k), v,
                                        mask)
        p = self._split(self._columns(self.linear_pos(pos_emb)))
        if p.shape[0] == 1:
            bd = torch.einsum("bqhd,phd->bhqp", q_v, p[0])
        else:
            bd = torch.einsum("bqhd,bphd->bhqp", q_v, p)
        if split is not None:
            # the rows' distances: i - j from off+T1-1 down to off-n+1
            bd = bd[..., n - off - T1:2 * n - 1 - off]
            scores = (ac + rel_shift(bd, n)) / math.sqrt(self.d_k)
        else:
            scores = (ac + rel_shift(bd)[..., :T2]) / math.sqrt(self.d_k)
        if self.zero_triu:
            tri = torch.ones(T1, T2, dtype=torch.bool,
                             device=scores.device).tril(T2 - T1)
            scores = scores.masked_fill(~tri, 0.0)
        return self._softmax_attend(scores, v, mask)


def safe_exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive cumprod as exp∘cumsum∘log, the first element 1.  The
    clip is ``minimum(maximum(x, tiny), 1)``, not ``clamp``: at x == 1 (a
    choose-probability that rounds to 0) the gradient splits the tie in
    half, as ``jnp.clip``'s does; ``clamp`` would pass all of it."""
    lo = x.new_full((), torch.finfo(x.dtype).tiny)
    csum = torch.cumsum(torch.log(torch.minimum(torch.maximum(x, lo),
                                                torch.ones_like(lo))),
                        dim=dim)
    n = x.shape[dim]
    return torch.cat([torch.ones_like(x.narrow(dim, 0, 1)),
                      torch.exp(csum).narrow(dim, 0, n - 1)], dim=dim)


class MTMultiHeadedAttention(MultiHeadedAttention):
    """Monotonic truncated attention (state_dict adds ``src_att_bias``,
    shape (1, 1))."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 bias_init: float = 0.0, sigmoid_noise: float = 1.0):
        super().__init__(n_head, n_feat, dropout_rate)
        self.sigmoid_noise = sigmoid_noise
        self.src_att_bias = nn.Parameter(torch.full((1, 1), bias_init))

    def _scores(self, q, k):
        """(B, H, T1, T2) choose-scores of projected q and k."""
        return (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
                + self.src_att_bias.to(q.dtype))

    def _monotonic(self, scores, mask, noise=None):
        """Choose-probabilities (masked keys 0) times their exclusive
        survival.  ``noise``: N(0, 1) draws of the scores' shape, added
        times ``sigmoid_noise`` before the sigmoid (training)."""
        if noise is not None and self.sigmoid_noise > 0:
            scores = scores + self.sigmoid_noise * noise
        if mask is not None:
            while mask.ndim < scores.ndim:
                mask = mask[:, None] if mask.ndim == 3 else mask[None]
            p = torch.sigmoid(scores.masked_fill(
                ~mask, torch.finfo(scores.dtype).min)).masked_fill(~mask, 0.0)
        else:
            p = torch.sigmoid(scores)
        return p * safe_exclusive_cumprod(1.0 - p)

    def _out(self, attn, v):
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        B, T1 = x.shape[:2]
        return self._project_out(x.reshape(B, T1, self.n_feat))

    def forward(self, query, key, value, mask=None, return_attn=False):
        """In train mode with ``sigmoid_noise > 0`` the scores take
        ``sigmoid_noise`` · N(0, 1) drawn from the dropout generator."""
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        scores = self._scores(q, k)
        noise = standard_normal(scores) \
            if self.training and self.sigmoid_noise > 0 else None
        attn = self._monotonic(scores, mask, noise)
        _record(self, attn)
        out = self._out(dropout(attn, self.dropout_rate, self.training), v)
        return (out, attn) if return_attn else out

    def attend_monotonic(self, q, k, v, mask=None):
        """Untruncated monotonic attention over precomputed K/V."""
        return self._out(self._monotonic(self._scores(q, k), mask), v)

    def decode_scores(self, q, k, mask=None):
        """q: (B, 1, H, dk); k: (B, T2, H, dk); mask: optional (B, T2) key
        validity.  Returns (B, H, T2) scores, masked keys at the f32
        minimum."""
        s = self._scores(q, k)[:, :, 0, :]
        if mask is not None:
            s = s.masked_fill(~mask[:, None, :], torch.finfo(s.dtype).min)
        return s

    def decode_context(self, s, v, endpoint):
        """Sigmoid-survival weights of scores ``s`` (B, H, T2), truncated
        past the (already advanced) ``endpoint`` (B, H), over v (B, T2, H,
        dk).  Returns (B, 1, n_feat)."""
        p = torch.sigmoid(s)
        attn = p * safe_exclusive_cumprod(1.0 - p)
        pos = torch.arange(s.shape[-1], device=s.device)
        attn = attn.masked_fill(pos > endpoint[..., None], 0.0)
        x = torch.einsum("bhk,bkhd->bhd", attn, v)
        return self.linear_out(x.reshape(x.shape[0], 1, self.n_feat))

    @staticmethod
    def advance_endpoint(s, endpoint):
        """The first position past ``endpoint`` with a positive score, else
        ``endpoint``.  s: (..., T2); endpoint: (...).  Returns
        (new_endpoint, advanced)."""
        pos = torch.arange(s.shape[-1], device=s.device)
        cand = (pos > endpoint[..., None]) & (s > 0)
        has = cand.any(dim=-1)
        first = cand.to(torch.uint8).argmax(dim=-1)
        return torch.where(has, first, endpoint), has

    def decode_attend(self, q, k, v, endpoint, mask=None):
        """One decode step: advance each head's endpoint, then attend
        truncated past it.  Returns (context (B, 1, n_feat), new endpoint
        (B, H))."""
        s = self.decode_scores(q, k, mask)
        new_ep, _ = self.advance_endpoint(s, endpoint)
        return self.decode_context(s, v, new_ep), new_ep
