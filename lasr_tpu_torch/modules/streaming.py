"""Streaming encoder and decoder (counterpart of ``ChunkEncoder``,
``StreamDecoder`` and their layers in ``lasr_tpu/modules/streaming.py``).

  - ``StreamEncoderLayer``: pre-norm self-attention over [memory ‖ chunk]
    keys, where the memory is the stream's last ``mem_len_sub`` normed
    frames of earlier chunks' hop regions (detached), and a ReLU
    feed-forward.  ``forward`` takes one chunk against a carried memory;
    ``forward_all_chunks`` takes every chunk of a stream at once, each
    chunk's memory being a chunk-shifted view of the layer's own normed
    input (it depends on the layer's input only, never on its output).
  - ``ChunkEncoder``: chunks of (cur+right+6) raw frames advancing by
    ``hop``, each conv-subsampled with its own positional offset; the
    full-stream ``forward`` runs layer by layer over all n·B chunk rows
    (the JAX module's layer-major form, which ``lasr_tpu``'s tests pin
    equal to its sequential chunk scan), ``encode_chunk`` serves one
    chunk against carried memories.  Each chunk keeps its first
    cur/4 outputs; the conv margin's extra trailing column is masked out
    of the keys (``key_sub``).  Its training knobs: ``remat`` (each
    layer recomputed in the backward, ``modules.remat``),
    ``layer_major_rows`` (the attention and feed-forward of a layer in
    groups of at most that many chunk rows, each group recomputed in the
    backward) and ``conv_once`` (the subsampling conv once over the
    stream, each chunk's rows sliced from it).
  - ``DualTransformerEncoder``: the offline view and the chunk-masked
    online view over one Transformer encoder (``core``), and its
    incremental per-chunk forward; ``ParallelDynamicDualEncoder`` runs
    both views as one 2B-row batch with a chunk size drawn per step.
  - ``StreamDecoderLayer`` / ``StreamDecoder``: the Transformer decoder
    with monotonic truncated source attention
    (``MTMultiHeadedAttention``), its full forward (optionally returning
    the per-layer attention maps), and three cached decode steps: the
    untruncated monotonic step (``forward_one_step``), the online step
    with per-head endpoints (``forward_one_step_online``), and the beam
    search's online step whose endpoints chain across same-parent
    siblings in beam order (``forward_one_step_ep``).

The full forwards train: dropout where ``lasr_tpu`` drops out (after
each attention and feed-forward branch, inside the feed-forward, on the
attention probabilities, after the positional encodings), drawn from
``modules.dropout``'s generator, and the source attention's sigmoid
noise.  Norms, projections and the embedding are ``modules.layers``'
casting layers, so a model computes in its compute dtype (bf16 as
``lasr_tpu``'s ``dtype=jnp.bfloat16``); the memories and the decode
caches are kept in it.

Cached steps are eval-only and write the step's self-attention keys and
values into the cache in place.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.attention import (MTMultiHeadedAttention,
                                              MultiHeadedAttention)
from lasr_tpu_torch.modules.dropout import dropout, shared_randint
from lasr_tpu_torch.modules.embedding import PositionalEncoding, sinusoid_rows
from lasr_tpu_torch.modules.feed_forward import PositionwiseFeedForward
from lasr_tpu_torch.modules.layers import Embedding, LayerNorm, Linear
from lasr_tpu_torch.modules.remat import checkpointed
from lasr_tpu_torch.modules.subsampling import Conv2dSubsampling
from lasr_tpu_torch.modules.transformer import LAYERNORM_EPS, Encoder
from lasr_tpu_torch.utils.masks import chunk_attention_mask


class StreamEncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, hop_sub: int = 16,
                 mem_len_sub: int = 16):
        super().__init__()
        self.self_attn = MultiHeadedAttention(attention_heads, size,
                                              attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm2 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.dropout_rate = dropout_rate
        self.hop_sub, self.mem_len_sub = hop_sub, mem_len_sub

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training)

    def _attend_ff(self, xh, kx, kmask, residual):
        x = residual + self._drop(self.self_attn(xh, kx, kx, kmask))
        return x + self._drop(self.feed_forward(self.norm2(x)))

    def forward(self, x, mem, kmask):
        """x: (B, Tc, D) chunk; mem: (B, M, D) carried memory; kmask:
        (B, 1, M+Tc) key validity.  Returns (out, new memory)."""
        xh = self.norm1(x)
        out = self._attend_ff(xh, torch.cat([mem, xh], dim=1), kmask, x)
        new_mem = torch.cat([mem, xh[:, : self.hop_sub]], dim=1)
        return out, new_mem[:, -self.mem_len_sub:].detach()

    def forward_all_chunks(self, x, kmask, n: int, row_cap: int = 0):
        """All n chunks at once.  x: (n·B, Tc, D) chunk-major; kmask:
        (n·B, 1, M+Tc).  Chunk c's memory is the normed hop regions of
        chunks < c, the last M frames of them (zeros before the stream).
        ``row_cap`` > 0: the attention and feed-forward (row-independent
        once the memories are gathered) run over groups of at most
        row_cap chunk rows, each recomputed in the backward, so the peak
        of their temporaries scales with row_cap, not n·B.  Returns
        (n·B, Tc, D)."""
        xh = self.norm1(x)
        NB, Tc, D = xh.shape
        B = NB // n
        M, hop = self.mem_len_sub, self.hop_sub
        hops = xh.reshape(n, B, Tc, D)[:, :, :hop]
        stream = F.pad(hops.transpose(0, 1).reshape(B, n * hop, D),
                       (0, 0, M, 0))
        idx = (torch.arange(n, device=x.device) * hop)[:, None] \
            + torch.arange(M, device=x.device)[None, :]
        mem = stream[:, idx].transpose(0, 1).reshape(NB, M, D).detach()
        kx = torch.cat([mem, xh], dim=1)
        if row_cap and row_cap < NB:
            return torch.cat([
                checkpointed(self._attend_ff, *(a[lo: lo + row_cap]
                                                for a in (xh, kx, kmask, x)))
                for lo in range(0, NB, row_cap)])
        return self._attend_ff(xh, kx, kmask, x)


def _chunk_grid(T_raw: int, cur: int, right: int, hop: int) -> int:
    """Number of sliding chunks the reference iterator yields for T_raw
    frames (left 0, right pad right+6)."""
    padded = T_raw + right + 6
    n = i = 0
    while i + cur + right < padded - 6 + hop:
        n += 1
        i += hop
    return n


class ChunkEncoder(nn.Module):
    """Streaming chunked encoder: x (B, T, idim), x_len (B,) → (hs (B,
    n·cur/4, D), hs_len (B,)).

    Memory knobs of the training forward (``lasr_tpu``'s): ``remat``
    recomputes each layer in the backward; ``layer_major_rows`` > 0
    groups each layer's attention and feed-forward by at most that many
    chunk rows (the same numbers as one group); ``conv_once`` runs the
    subsampling conv once over the whole stream and slices each chunk's
    rows from it: stream row c·hop/4 + j reads the raw taps and the
    positional index of chunk c's row j, so the outputs match the
    per-chunk form up to the conv's summation order, and in training
    the overlapping rows share one positional-dropout draw where the
    per-chunk form draws for each chunk.  With dropout on, ``remat``
    alone keeps the draws of the plain forward."""

    def __init__(self, idim: int, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d", left_len: int = 64,
                 cur_len: int = 64, right_len: int = 64, hop_len: int = 64,
                 remat: bool = False, layer_major: bool = True,
                 layer_major_rows: int = 0, conv_once: bool = False):
        super().__init__()
        if input_layer != "conv2d":
            raise NotImplementedError(
                f"ChunkEncoder input_layer {input_layer!r}: conv2d only, as "
                f"in lasr_tpu")
        self.remat, self.conv_once = remat, conv_once
        self.layer_major_rows = layer_major_rows
        # layer_major=False selects lasr_tpu's sequential chunk scan, the
        # same numbers as the layer-major form this forward runs
        del layer_major
        self.attention_dim, self.num_blocks = attention_dim, num_blocks
        self.cur_len, self.right_len, self.hop_len = cur_len, right_len, \
            hop_len
        self.sub = 4
        self.embed = Conv2dSubsampling(
            idim, attention_dim,
            PositionalEncoding(attention_dim, positional_dropout_rate),
            dropout_rate)
        self.mem_len_sub = left_len // self.sub
        self.cur_sub = cur_len // self.sub
        self.hop_sub = hop_len // self.sub
        # a chunk of cur+right raw frames yields key_sub keys; the conv
        # runs over cur+right+6 so that chunks tile the stream, and the
        # one extra trailing column is never a key
        self.key_sub = ((cur_len + right_len - 1) // 2 - 1) // 2
        self.encoders = nn.ModuleList([
            StreamEncoderLayer(attention_dim, attention_heads, linear_units,
                               dropout_rate, attention_dropout_rate,
                               self.hop_sub, self.mem_len_sub)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)

    def _mem_mask(self, valid_mem):
        """(..., M) validity of the memory rows: the last ``valid_mem``."""
        M = self.mem_len_sub
        return torch.arange(M, device=valid_mem.device) \
            >= (M - valid_mem[..., None])

    def _forward_layer_major(self, chunks, offsets, valid_mem, key_valid,
                             x_pad):
        """chunks: (n, B, chunk_raw, idim); offsets / valid_mem: (n,);
        key_valid: (n, B, chunk_sub); x_pad: the padded stream (B, T',
        idim) the chunks were cut from.  Returns (n, B, cur_sub, D)."""
        n, B, chunk_raw, idim = chunks.shape
        dev = chunks.device
        Tc = ((chunk_raw - 1) // 2 - 1) // 2
        if self.conv_once:
            # stream row c·hop_sub + j is chunk c's row j
            h_full, _ = self.embed(x_pad, torch.full(
                (B,), x_pad.shape[1], dtype=torch.int32, device=dev))
            need = self.hop_sub * (n - 1) + Tc
            h_full = F.pad(h_full, (0, 0, 0, max(0, need - h_full.shape[1])))
            idx = (torch.arange(n, device=dev) * self.hop_sub)[:, None] \
                + torch.arange(Tc, device=dev)
            h = h_full[:, idx].transpose(0, 1).reshape(n * B, Tc, -1)
        else:
            h, _ = self.embed(
                chunks.reshape(n * B, chunk_raw, idim),
                torch.full((n * B,), chunk_raw, dtype=torch.int32,
                           device=dev),
                offset=offsets.repeat_interleave(B))
        M = self.mem_len_sub
        kmask = torch.cat([self._mem_mask(valid_mem)[:, None, :].expand(
            n, B, M), key_valid], dim=2).reshape(n * B, 1, M + Tc)
        for layer in self.encoders:
            if self.remat:
                h = checkpointed(layer.forward_all_chunks, h, kmask, n,
                                 self.layer_major_rows)
            else:
                h = layer.forward_all_chunks(h, kmask, n,
                                             self.layer_major_rows)
        return self.after_norm(h).reshape(n, B, Tc, -1)[:, :, : self.cur_sub]

    def forward(self, x, x_len, ref_tail: bool = False):
        """``ref_tail``: the reference decoder's length convention — no
        output zeroed, hs_len the row's solo chunk count × cur/4 (every
        frame of every chunk the reference iterator yields counts, the
        tail conv margin included).  Default: only frames backed by real
        audio are valid, the rest zeroed."""
        B, T, _ = x.shape
        cur, right, hop = self.cur_len, self.right_len, self.hop_len
        dev = x.device
        n = _chunk_grid(T, cur, right, hop)
        chunk_raw = cur + right + 6
        x_pad = F.pad(x, (0, 0, 0, right + 6 + hop))
        starts = torch.arange(n, device=dev) * hop
        chunks = x_pad[:, starts[:, None]
                       + torch.arange(chunk_raw, device=dev)[None, :]]
        chunk_sub = ((chunk_raw - 1) // 2 - 1) // 2
        j = torch.arange(chunk_sub, device=dev)
        key_valid = ((starts[:, None, None] + self.sub * j[None, None, :]
                      < x_len[None, :, None])
                     & (j < self.key_sub)[None, None, :])
        outs = self._forward_layer_major(
            chunks.transpose(0, 1), starts // self.sub,
            torch.clamp(starts // self.sub, max=self.mem_len_sub), key_valid,
            x_pad)
        hs = outs.transpose(0, 1).reshape(B, -1, self.attention_dim)
        if ref_tail:
            n_solo = torch.clamp((x_len + hop - cur - 1) // hop + 1, min=0)
            return hs, (torch.clamp(n_solo, max=n) * self.cur_sub).to(
                torch.int32)
        g = torch.arange(hs.shape[1], device=dev)
        valid = ((g // self.cur_sub) * hop + self.sub * (g % self.cur_sub)
                 )[None, :] < x_len[:, None]
        return (torch.where(valid[..., None], hs, 0.0),
                valid.sum(dim=1, dtype=torch.int32))

    def init_stream_state(self, batch: int):
        """Fresh per-layer memories for chunk-incremental serving, in the
        compute dtype."""
        norm = self.after_norm
        return tuple(norm.weight.new_zeros(
            batch, self.mem_len_sub, self.attention_dim, dtype=norm.dtype)
            for _ in range(self.num_blocks))

    def encode_chunk(self, chunk_x, chunk_idx: int, mems, n_valid=None):
        """Serve one chunk: chunk_x (B, cur+right+6, idim), the stream's
        frames [idx·hop, idx·hop + cur+right+6) (zero-padded at the end);
        mems from ``init_stream_state``; n_valid (B,) the valid frames seen
        so far (None: all of this chunk is signal).  Returns (out (B,
        cur/4, D), new mems); the sequence of chunks equals ``forward``."""
        B, chunk_raw, _ = chunk_x.shape
        dev = chunk_x.device
        offset = chunk_idx * self.hop_sub
        chunk_sub = ((chunk_raw - 1) // 2 - 1) // 2
        j = torch.arange(chunk_sub, device=dev)
        key_valid = (j < self.key_sub)[None, :].expand(B, chunk_sub)
        if n_valid is not None:
            key_valid = key_valid & ((chunk_idx * self.hop_len
                                      + self.sub * j)[None, :]
                                     < n_valid[:, None])
        h, _ = self.embed(chunk_x, torch.full((B,), chunk_raw,
                                              dtype=torch.int32, device=dev),
                          offset=offset)
        M = self.mem_len_sub
        valid_mem = torch.tensor(min(offset, M), device=dev)
        kmask = torch.cat([self._mem_mask(valid_mem)[None].expand(B, M),
                           key_valid], dim=1)[:, None, :]
        new_mems = []
        for layer, mem in zip(self.encoders, mems):
            h, m = layer(h, mem, kmask)
            new_mems.append(m)
        return self.after_norm(h)[:, : self.cur_sub], tuple(new_mems)


class DualTransformerEncoder(nn.Module):
    """The offline view and the chunk-masked online view of one
    Transformer encoder (``core``: ``encoder.core.*``, ``lasr_tpu``'s
    parameter tree).  The online view's attention is the block-chunk
    mask of ``attention_chunk`` subsampled frames (and, when
    ``attention_left`` >= 0, that many chunks to the left) under the
    padding mask."""

    def __init__(self, idim: int, attention_dim: int = 256,
                 attention_heads: int = 4, attention_chunk: int = 16,
                 attention_left: int = -1, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d"):
        super().__init__()
        self.attention_chunk, self.attention_left = attention_chunk, \
            attention_left
        self.core = Encoder(
            idim, attention_dim, attention_heads, linear_units, num_blocks,
            dropout_rate, positional_dropout_rate, attention_dropout_rate,
            input_layer)

    def _chunk_mask(self, size: int, device, chunk=None):
        return chunk_attention_mask(
            size, self.attention_chunk if chunk is None else chunk,
            self.attention_left, device=device)

    def _run(self, h, h_len, att_mask=None):
        mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < h_len[:, None])[:, None, :]
        if att_mask is not None:
            mask = mask & att_mask[None]
        return self.core.after_norm(self.core.run_layers(h, mask))

    def forward(self, x, x_len):
        """(offline view, online view, hs_len)."""
        h, h_len = self.core.embed_input(x, x_len)
        return (self._run(h, h_len),
                self._run(h, h_len, self._chunk_mask(h.shape[1], h.device)),
                h_len)

    def forward_offline(self, x, x_len):
        h, h_len = self.core.embed_input(x, x_len)
        return self._run(h, h_len), h_len

    def forward_online(self, x, x_len):
        h, h_len = self.core.embed_input(x, x_len)
        return self._run(h, h_len, self._chunk_mask(h.shape[1], h.device)
                         ), h_len

    def forward_per_chunk(self, x_raw, caches=None, right: int = 0):
        """Incremental chunk-masked inference (eval, conv2d input):
        ``x_raw`` (B, T_raw, idim) is every raw frame received so far;
        only the frames past the cached ones are embedded (with their
        positional offset), and each layer takes just the new rows as
        queries against its cached inputs.  ``caches``: the previous
        call's (None to start); ``right``: raw right-context frames held
        back and encoded again by the next call.  Returns (the new
        outputs (B, chunk', D), the new caches).  Calls cut at chunk
        boundaries (multiples of ``attention_chunk`` subsampled frames)
        give, concatenated, the online view."""
        right_sub = right // 4
        B = x_raw.shape[0]
        offset = 0 if caches is None else caches[0].shape[1]
        new_raw = x_raw[:, 4 * offset:]
        h, _ = self.core.embed_input(
            new_raw, torch.full((B,), new_raw.shape[1], dtype=torch.int32,
                                device=x_raw.device), pos_offset=offset)
        if caches is not None:
            h = torch.cat([caches[0], h], dim=1)
        hlen = h.shape[1]
        chunk, keep = hlen - offset, hlen - right_sub
        mask = self._chunk_mask(hlen, h.device)[None, -chunk:]
        new_caches = [h[:, :keep]]
        rows = h[:, -chunk:]
        for i, layer in enumerate(self.core.encoders):
            full = rows if caches is None else torch.cat([caches[i + 1],
                                                          rows], dim=1)
            rows = layer(full, mask, q_rows=chunk)
            new_caches.append(full[:, :keep])
        return self.core.after_norm(rows[:, : chunk - right_sub]), \
            new_caches


class ParallelDynamicDualEncoder(DualTransformerEncoder):
    """Both views in one forward over a 2B-row batch (offline rows, then
    online rows).  In training the online chunk is ``attention_chunk`` +
    U{0..16} - 8 (at least 1), drawn once per forward by
    ``modules.dropout.shared_randint``: from the ``Trainer``'s shared
    generator, in the same state on every data-parallel rank, so every
    rank masks alike (``lasr_tpu`` draws it once for the global batch).
    In eval the chunk is ``attention_chunk``."""

    def forward(self, x, x_len):
        h, h_len = self.core.embed_input(x, x_len)
        B, T = h.shape[:2]
        chunk = self.attention_chunk
        if self.training:
            chunk = max(1, chunk + shared_randint(17) - 8)
        pad = (torch.arange(T, device=h.device)[None, :]
               < h_len[:, None])[:, None, :]
        masks = torch.cat([pad.expand(B, T, T),
                           pad & self._chunk_mask(T, h.device, chunk)[None]])
        h2 = self.core.after_norm(self.core.run_layers(
            torch.cat([h, h]), masks))
        return h2[:B], h2[B:], h_len


class StreamDecoderLayer(nn.Module):
    def __init__(self, size: int, self_attention_heads: int,
                 src_attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 src_attention_bias_init: float = 0.0,
                 src_attention_sigmoid_noise: float = 1.0):
        super().__init__()
        self.self_attn = MultiHeadedAttention(self_attention_heads, size,
                                              self_attention_dropout_rate)
        self.src_attn = MTMultiHeadedAttention(
            src_attention_heads, size, src_attention_dropout_rate,
            bias_init=src_attention_bias_init,
            sigmoid_noise=src_attention_sigmoid_noise)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm2 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm3 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.dropout_rate = dropout_rate

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training)

    def forward(self, tgt, tgt_mask, memory, memory_mask,
                return_attn: bool = False):
        y = self.norm1(tgt)
        x = tgt + self._drop(self.self_attn(y, y, y, tgt_mask))
        out = self.src_attn(self.norm2(x), memory, memory, memory_mask,
                            return_attn=return_attn)
        att, attn = out if return_attn else (out, None)
        x = x + self._drop(att)
        x = x + self._drop(self.feed_forward(self.norm3(x)))
        return (x, attn) if return_attn else x

    def _self_step(self, x_t, pos: int, self_k, self_v):
        """The cached self-attention half of a step: writes the step's
        keys and values at ``pos`` and returns (x, the source query)."""
        y = self.norm1(x_t)
        q = self.self_attn.project_q(y)
        k_new, v_new = self.self_attn.project_kv(y, y)
        self_k[:, pos] = k_new[:, 0]
        self_v[:, pos] = v_new[:, 0]
        prefix = (torch.arange(self_k.shape[1], device=x_t.device)
                  <= pos)[None, None, :]
        x = x_t + self.self_attn.attend(q, self_k, self_v, prefix)
        return x, self.src_attn.project_q(self.norm2(x))

    def _ff(self, x):
        return x + self.feed_forward(self.norm3(x))

    def step_offline(self, x_t, pos: int, self_k, self_v, mem_k, mem_v,
                     mem_mask):
        """One step with untruncated monotonic source attention."""
        x, q = self._self_step(x_t, pos, self_k, self_v)
        return self._ff(x + self.src_attn.attend_monotonic(q, mem_k, mem_v,
                                                           mem_mask))

    def step_online_chained(self, x_t, pos: int, self_k, self_v, mem_k,
                            mem_v, ep_slots, parent, alive, mem_mask=None):
        """One beam step with the reference's sibling-chained endpoints:
        every child of a parent shares (and advances in place) the
        parent's endpoint state, so in beam order each hypothesis starts
        from the endpoints its earlier siblings left.  x_t: (B·K, 1, D);
        ep_slots: (B, K, H) endpoints per previous beam slot; parent /
        alive: (B, K).  A Python loop over the K slots on (B, H) tensors.
        Returns (x, ep_eff (B, K, H), ep_stall (B, K)): each hypothesis's
        endpoints this step (the next step's per-slot state) and whether a
        live one found no candidate among the visible keys."""
        x, q = self._self_step(x_t, pos, self_k, self_v)
        s = self.src_attn.decode_scores(q, mem_k, mask=mem_mask)
        B, K = parent.shape
        sK = s.reshape(B, K, *s.shape[1:])
        rows = torch.arange(B, device=s.device)
        slots = torch.arange(K, device=s.device)
        ep_state = ep_slots
        eps, stalls = [], []
        for k in range(K):
            p_k, a_k = parent[:, k], alive[:, k]
            cur = ep_state[rows, p_k]                             # (B, H)
            new, has = self.src_attn.advance_endpoint(sK[:, k], cur)
            new = torch.where(a_k[:, None], new, cur)
            stalls.append(a_k & (~has).any(dim=-1))
            upd = (slots[None, :] == p_k[:, None]) & a_k[:, None]
            ep_state = torch.where(upd[:, :, None], new[:, None, :], ep_state)
            eps.append(new)
        ep_eff = torch.stack(eps, dim=1)
        att = self.src_attn.decode_context(s, mem_v, ep_eff.reshape(B * K, -1))
        return self._ff(x + att), ep_eff, torch.stack(stalls, dim=1)

    def step_online(self, x_t, pos: int, self_k, self_v, memory, endpoint):
        """One online step over raw memory with per-head endpoint advance.
        Returns (x, new endpoint (B, H))."""
        x, q = self._self_step(x_t, pos, self_k, self_v)
        mk, mv = self.src_attn.project_kv(memory, memory)
        att, new_ep = self.src_attn.decode_attend(q, mk, mv, endpoint)
        return self._ff(x + att), new_ep


class StreamDecoder(nn.Module):
    def __init__(self, odim: int, attention_dim: int = 256,
                 self_attention_heads: int = 4, src_attention_heads: int = 1,
                 linear_units: int = 2048, num_blocks: int = 6,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 src_attention_bias_init: float = 0.0,
                 src_attention_sigmoid_noise: float = 1.0,
                 input_layer: str = "embed"):
        super().__init__()
        if input_layer != "embed":
            raise NotImplementedError(
                f"StreamDecoder input_layer {input_layer!r}: embed only, as "
                f"in lasr_tpu")
        self.attention_dim = attention_dim
        self.self_attention_heads = self_attention_heads
        self.src_attention_heads = src_attention_heads
        self.embed = nn.Sequential(
            Embedding(odim, attention_dim),
            PositionalEncoding(attention_dim, positional_dropout_rate))
        self.decoders = nn.ModuleList([
            StreamDecoderLayer(attention_dim, self_attention_heads,
                               src_attention_heads, linear_units,
                               dropout_rate, self_attention_dropout_rate,
                               src_attention_dropout_rate,
                               src_attention_bias_init,
                               src_attention_sigmoid_noise)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)
        self.output_layer = Linear(attention_dim, odim)

    def forward(self, tgt, tgt_mask, memory, memory_mask,
                collect_attn: bool = False):
        """Logits (B, L, odim); with ``collect_attn`` also the per-layer
        source attention maps concatenated, (B, layers·H, L, T)."""
        x = self.embed(tgt)
        attns = []
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask,
                      return_attn=collect_attn)
            if collect_attn:
                x, attn = x
                attns.append(attn)
        logits = self.output_layer(self.after_norm(x))
        return (logits, torch.cat(attns, dim=1)) if collect_attn else logits

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Self-attention K/V caches (layers, B, Lmax, H, dk) in the
        compute dtype and the source-attention endpoints (layers, B,
        H_src), -1 at the start."""
        H = self.self_attention_heads
        shape = (len(self.decoders), batch, max_len, H,
                 self.attention_dim // H)
        out = self.output_layer
        w = out.weight
        return {"k": w.new_zeros(shape, dtype=out.dtype),
                "v": w.new_zeros(shape, dtype=out.dtype),
                "ep": torch.full((len(self.decoders), batch,
                                  self.src_attention_heads), -1,
                                 dtype=torch.long, device=w.device)}

    def project_memory(self, memory):
        """Per-layer source-attention K/V, stacked (layers, B, T, H, dk)."""
        kv = [layer.src_attn.project_kv(memory, memory)
              for layer in self.decoders]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def _embed_step(self, y_t, pos: int):
        h = self.embed[0](y_t[:, None])
        pe = torch.from_numpy(sinusoid_rows([pos], self.attention_dim))
        return h * math.sqrt(self.attention_dim) + pe.to(h.device, h.dtype)

    def _logp(self, h):
        return torch.log_softmax(
            self.output_layer(self.after_norm(h)[:, 0]), dim=-1)

    def forward_one_step(self, y_t, pos: int, cache, mem_k, mem_v, mem_mask):
        """Cached step with untruncated monotonic source attention over
        pre-projected memory.  Returns (log-probs (B, odim), cache)."""
        h = self._embed_step(y_t, pos)
        for i, layer in enumerate(self.decoders):
            h = layer.step_offline(h, pos, cache["k"][i], cache["v"][i],
                                   mem_k[i], mem_v[i], mem_mask)
        return self._logp(h), cache

    def forward_one_step_ep(self, y_t, pos: int, cache, mem_k, mem_v,
                            mem_mask=None, parent=None, alive=None):
        """The online beam step (endpoint-truncated source attention over
        pre-projected memory, endpoints chained across siblings; see
        ``StreamDecoderLayer.step_online_chained``).  mem_mask: (B·K, 1, T)
        or (B·K, T); parent / alive: (B, K).  cache["ep"] (layers, B·K, H)
        holds endpoints per previous beam SLOT: the caller must not reorder
        it by parent.  Returns (log-probs, cache, ep_stall (B, K))."""
        if mem_mask is not None and mem_mask.ndim == 3:
            mem_mask = mem_mask[:, 0, :]
        B, K = parent.shape
        h = self._embed_step(y_t, pos)
        ep_stall = torch.zeros(B, K, dtype=torch.bool, device=h.device)
        eps = []
        for i, layer in enumerate(self.decoders):
            h, ep, stall = layer.step_online_chained(
                h, pos, cache["k"][i], cache["v"][i], mem_k[i], mem_v[i],
                cache["ep"][i].reshape(B, K, -1), parent, alive, mem_mask)
            eps.append(ep.reshape(B * K, -1))
            ep_stall = ep_stall | stall
        cache["ep"] = torch.stack(eps)
        return self._logp(h), cache, ep_stall

    def forward_one_step_online(self, y_t, pos: int, cache, memory):
        """y_t: (B,); memory: (B, T, D).  Returns (log-probs (B, odim),
        cache with the advanced endpoints)."""
        h = self._embed_step(y_t, pos)
        eps = []
        for i, layer in enumerate(self.decoders):
            h, ep = layer.step_online(h, pos, cache["k"][i], cache["v"][i],
                                      memory, cache["ep"][i])
            eps.append(ep)
        cache["ep"] = torch.stack(eps)
        return self._logp(h), cache
