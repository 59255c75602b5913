"""Multi-head attention (counterpart of ``lasr_tpu/modules/attention.py``).

  - ``MultiHeadedAttention``: scaled-dot MHA with ``project_q`` /
    ``project_kv`` / ``attend``, so cached decode reuses the projections.
  - ``RelPositionMultiHeadedAttention``: Transformer-XL relative-position
    scoring with pos_bias_u/v.  Three deterministic paths, as in the JAX
    module: the rotated fold in plain PyTorch, the rotated fold through
    the rot kernel (``rot_fold_pallas``), and the rel kernel
    (``use_pallas``).  The table and rel-shift paths, which the JAX
    package uses for training, belong to the training slice.

All masks are boolean with True = attendable.  Inference only: dropout
is the identity.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from lasr_tpu_torch.modules.embedding import sinusoid_table
from lasr_tpu_torch.ops.rel_attention import rel_attention_forward
from lasr_tpu_torch.ops.rot_attention import rot_attention_forward


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
    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} is not a multiple of n_head "
                             f"{n_head}")
        self.n_head, self.n_feat = n_head, n_feat
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_head, self.d_k)

    def project_q(self, query):
        return self._split(self.linear_q(query))          # (B, T1, H, dk)

    def project_kv(self, key, value):
        return self._split(self.linear_k(key)), self._split(self.linear_v(value))

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
        x = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        B, T1 = x.shape[:2]
        return self.linear_out(x.reshape(B, T1, self.n_feat))

    def attend(self, q, k, v, mask=None):
        """q: (B, T1, H, dk); k/v: (B, T2, H, dk)."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        return self._softmax_attend(scores, v, mask)

    def forward(self, query, key, value, mask=None):
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        return self.attend(q, k, v, mask)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """``rot_fold``: merge content and position scores into one product
    over dk+M lanes via the sinusoid angle-addition identity (valid for the
    undropped, unclamped sinusoid table the conformer encoder owns).
    ``rot_fold_pallas``: run that fold through the rot kernel.
    ``use_pallas``: run the rel-pos scoring through the rel kernel (checked
    first, as in the JAX module).  Both kernel paths need a key-prefix
    padding mask."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 zero_triu: bool = False, use_pallas: bool = False,
                 rot_fold: bool = False, rot_fold_pallas: bool = False):
        super().__init__(n_head, n_feat, dropout_rate)
        self.zero_triu = zero_triu
        self.use_pallas = use_pallas
        self.rot_fold = rot_fold
        self.rot_fold_pallas = rot_fold_pallas
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def _heads_major(self, x):
        """(B, T, H, e) → contiguous (B*H, T, e), bh = b*H + h."""
        B, T, H, e = x.shape
        return x.permute(0, 2, 1, 3).reshape(B * H, T, e).contiguous()

    def _from_heads_major(self, ctx, B, T):
        ctx = ctx.reshape(B, self.n_head, T, self.d_k).permute(0, 2, 1, 3)
        return self.linear_out(ctx.reshape(B, T, self.n_feat))

    def _rel_kernel_attend(self, query, key, value, pos_emb, mask):
        B, T, _ = query.shape
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        p = self._split(self.linear_pos(pos_emb))[0]       # (2T-1, H, dk)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)
        hm = self._heads_major
        ctx, _ = rel_attention_forward(
            hm(q_u), hm(q_v), hm(k), hm(v), p.permute(1, 0, 2).contiguous(),
            _key_lengths(mask, B, T, self.n_head, query.device))
        return self._from_heads_major(ctx, B, T)

    def _rot_fold_attend(self, q_u, q_v, k, v, mask):
        """``bd[i,j] = q_v_i · p(i−j)`` decomposes exactly as ``u_i · V_j``
        with ``u = rot_i(q_v @ W_pos)`` a per-query 2x2 rotation per
        frequency pair, so scores = [q_u ; u] @ [k ; V]^T / sqrt(dk)."""
        B, T = q_u.shape[:2]
        M, H, dk = self.n_feat, self.n_head, self.d_k
        kmat = self.linear_pos.weight.t().reshape(M, H, dk).to(q_v.dtype)
        z = torch.einsum("bqhd,mhd->bqhm", q_v, kmat)      # (B, T, H, M)
        W, V = _rot_tables(T, M)
        W = torch.from_numpy(W).to(z.device, z.dtype)
        si = W[None, :, None, 0::2]
        ci = W[None, :, None, 1::2]
        zs, zc = z[..., 0::2], z[..., 1::2]
        u = torch.stack([zs * si + zc * ci, zc * si - zs * ci],
                        dim=-1).reshape(z.shape)
        vt = torch.from_numpy(V).to(k.device, k.dtype)     # (T, M)
        if self.rot_fold_pallas and _is_key_prefix_mask(mask):
            hm = self._heads_major
            ctx, _ = rot_attention_forward(
                hm(q_u), hm(u), hm(k), hm(v), vt,
                _key_lengths(mask, B, T, H, q_u.device))
            return self._from_heads_major(ctx, B, T)
        qcat = torch.cat([q_u, u], dim=-1)                 # (B, T, H, dk+M)
        kcat = torch.cat([k, vt[None, :, None, :].expand(B, T, H, M)], dim=-1)
        scores = torch.einsum("bqhe,bkhe->bhqk", qcat, kcat) / math.sqrt(dk)
        return self._softmax_attend(scores, v, mask)

    def forward(self, query, key, value, pos_emb, mask=None):
        T1, T2 = query.shape[1], key.shape[1]
        shared_table = (pos_emb is not None and pos_emb.shape[0] == 1
                        and pos_emb.shape[1] == 2 * T1 - 1)
        if (self.use_pallas and not self.zero_triu and T1 == T2
                and shared_table and _is_key_prefix_mask(mask)):
            return self._rel_kernel_attend(query, key, value, pos_emb, mask)
        if not (self.rot_fold and not self.zero_triu and T1 == T2
                and shared_table):
            raise NotImplementedError(
                "only the rotated-fold and rel-kernel paths are ported; the "
                "table / rel-shift paths belong to the training slice")
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        q_u = q + self.pos_bias_u.to(q.dtype)
        q_v = q + self.pos_bias_v.to(q.dtype)
        return self._rot_fold_attend(q_u, q_v, k, v, mask)
