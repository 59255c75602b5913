"""Transformer encoder and decoder stacks (counterpart of
``lasr_tpu/modules/transformer.py``).

``Encoder``: an input layer with the absolute positional encoding,
pre-norm blocks of self-attention and a ReLU feed-forward, and an
after-norm; ``remat`` recomputes each block in the backward
(``modules.remat``).  Its input layers are those of the JAX module:
``"conv2d"`` (the subsampling), ``"linear"`` (Linear → LayerNorm →
dropout → ReLU), ``"embed"`` (token ids through an embedding, state_dict
``embed.0.weight``) and None (the positional encoding alone).
``EncoderLayer(..., q_rows=n)`` takes the last n rows alone as queries
(the per-chunk streaming forward of the dual encoder).

Decoder: pre-norm residual blocks (LayerNorm eps 1e-12) of self-attention,
source attention and a ReLU feed-forward, each branch dropped out before
its residual add in training, with an after-norm and the output
projection.  Cached decode keeps fixed-shape per-layer KV caches
``(layers, B, Lmax, H, dk)``: ``init_cache`` / ``project_memory`` /
``forward_one_step`` (eval only).  ``forward_one_step`` writes the new
step's keys and values into the cache it is given, in place.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from lasr_tpu_torch.modules.attention import MultiHeadedAttention
from lasr_tpu_torch.modules.dropout import dropout, time_shard
from lasr_tpu_torch.modules.embedding import PositionalEncoding, sinusoid_rows
from lasr_tpu_torch.modules.feed_forward import PositionwiseFeedForward
from lasr_tpu_torch.modules.layers import Embedding, LayerNorm, Linear
from lasr_tpu_torch.modules.remat import checkpointed
from lasr_tpu_torch.modules.subsampling import Conv2dSubsampling
from lasr_tpu_torch.parallel import dist

LAYERNORM_EPS = 1e-12  # reference layer_norm.py eps


def seq_pad_input(x: torch.Tensor, conv2d: bool, size: int):
    """(x padded at the end of its time axis so that the encoder's length
    divides ``size`` seq ranks, the unpadded encoder length or None when
    nothing was padded), as ``lasr_tpu``'s encoders pad under an
    activation sharding: 4·((−T_enc) mod size) input frames under the
    conv2d subsampling (T_enc its output length), (−T) mod size
    otherwise.  The padded frames are batch padding past every row's
    length, which the caller caps at the unpadded length."""
    t_enc = ((x.shape[1] - 1) // 2 - 1) // 2 if conv2d else x.shape[1]
    pad = (4 if conv2d else 1) * ((-t_enc) % size)
    if not pad:
        return x, None
    zeros = x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))
    return torch.cat([x, zeros], dim=1), t_enc


def time_split_blocks(blocks, h, conv_zero, after_norm, split: bool):
    """``after_norm(blocks(h, conv_zero))``; with ``split``, over this seq
    rank's rows of h's time axis (``dist.seq_split``), gathered after the
    norm (each rank's loss is the whole one, so the gather's backward
    keeps the rank's rows)."""
    if not split:
        return after_norm(blocks(h, conv_zero))
    with dist.seq_split(h.shape[1]) as s:
        def rows(a):
            return None if a is None else a.narrow(1, s.offset, s.local)
        out = after_norm(blocks(rows(h), rows(conv_zero)))
    return dist.seq_gather_output(out, 1)


class EncoderLayer(nn.Module):
    """Pre-norm self-attention + feed-forward block."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadedAttention(attention_heads, size,
                                              attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm2 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.dropout_rate = dropout_rate

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training, time_shard(1))

    def forward(self, x, mask, q_rows=None):
        """``q_rows``: only the last q_rows positions are queries (keys
        and values span all of x), and only those rows come back; a
        (B, T, T) mask keeps its last q_rows rows."""
        y = q = self.norm1(x)
        if q_rows is not None:
            x, q = x[:, -q_rows:], y[:, -q_rows:]
            if mask is not None and mask.ndim == 3 and mask.shape[1] > 1:
                mask = mask[:, -q_rows:]
        x = x + self._drop(self.self_attn(q, y, y, mask))
        return x + self._drop(self.feed_forward(self.norm2(x)))


class Encoder(nn.Module):
    """x (B, T, idim), x_len (B,) → (hs (B, T', D), hs_len (B,))."""

    def __init__(self, idim: int, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d", remat: bool = False,
                 act_sharding: bool = False):
        super().__init__()
        self.input_layer = input_layer
        self.remat = remat
        self.act_sharding = act_sharding
        pos_enc = PositionalEncoding(attention_dim, positional_dropout_rate)
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(idim, attention_dim, pos_enc,
                                           dropout_rate)
        elif input_layer == "linear":
            self.embed_linear = Linear(idim, attention_dim)
            self.embed_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)
            self.embed_pos = pos_enc
        elif input_layer == "embed":
            self.embed = nn.Sequential(Embedding(idim, attention_dim),
                                       pos_enc)
        elif input_layer is None:
            self.embed_pos = pos_enc
        else:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.dropout_rate = dropout_rate
        self.encoders = nn.ModuleList([
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         dropout_rate, attention_dropout_rate)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)

    def embed_input(self, x, x_len, solo_len: bool = False, pos_offset=0):
        if self.input_layer == "conv2d":
            return self.embed(x, x_len, solo_len=solo_len, offset=pos_offset)
        if self.input_layer == "embed":
            return self.embed[1](self.embed[0](x), pos_offset), x_len
        if self.input_layer == "linear":
            x = torch.relu(dropout(self.embed_norm(self.embed_linear(x)),
                                   self.dropout_rate, self.training))
        return self.embed_pos(x, pos_offset), x_len

    def forward(self, x, x_len, solo_pad: bool = False, pos_offset=0):
        """``solo_pad``: per-row lengths as if each utterance were encoded
        alone (decode time).  ``pos_offset``: the positional encoding's
        start position(s), an int or a (B,) tensor (long-form windows).
        ``act_sharding`` with several seq ranks splits the blocks' time
        axis over them, as the Conformer encoder does."""
        split = self.act_sharding and dist.seq_size() > 1
        len_cap = None
        if split:
            x, len_cap = seq_pad_input(x, self.input_layer == "conv2d",
                                       dist.seq_size())
        h, h_len = self.embed_input(x, x_len, solo_len=solo_pad,
                                    pos_offset=pos_offset)
        if len_cap is not None:
            h_len = torch.clamp(h_len, max=len_cap)
        mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < h_len[:, None])[:, None, :]
        return time_split_blocks(lambda h, _: self.run_layers(h, mask), h,
                                 None, self.after_norm, split), h_len

    def run_layers(self, h, mask):
        """The blocks over h (B, T, D) under a (B, 1 or T, T) mask."""
        for layer in self.encoders:
            h = checkpointed(layer, h, mask) if self.remat else layer(h, mask)
        return h


class DecoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadedAttention(attention_heads, size,
                                              self_attention_dropout_rate)
        self.src_attn = MultiHeadedAttention(attention_heads, size,
                                             src_attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm2 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm3 = LayerNorm(size, eps=LAYERNORM_EPS)
        self.dropout_rate = dropout_rate

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        y = self.norm1(tgt)
        x = tgt + self._drop(self.self_attn(y, y, y, tgt_mask))
        y = self.norm2(x)
        x = x + self._drop(self.src_attn(y, memory, memory, memory_mask))
        return x + self._drop(self.feed_forward(self.norm3(x)))

    def step(self, x_t, pos: int, self_k, self_v, mem_k, mem_v, mem_mask):
        """One cached decode step.  x_t: (B, 1, D); self_k/v: (B, Lmax, H,
        dk) caches, written in place at ``pos``; mem_k/v: (B, T, H, dk);
        mem_mask: (B, 1, T).  Returns (B, 1, D)."""
        y = self.norm1(x_t)
        q = self.self_attn.project_q(y)
        k_new, v_new = self.self_attn.project_kv(y, y)
        self_k[:, pos] = k_new[:, 0]
        self_v[:, pos] = v_new[:, 0]
        Lmax = self_k.shape[1]
        prefix = (torch.arange(Lmax, device=x_t.device) <= pos)[None, None, :]
        x = x_t + self.self_attn.attend(q, self_k, self_v, prefix)
        y = self.norm2(x)
        q = self.src_attn.project_q(y)
        x = x + self.src_attn.attend(q, mem_k, mem_v, mem_mask)
        return x + self.feed_forward(self.norm3(x))


class Decoder(nn.Module):
    def __init__(self, odim: int, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 input_layer: str = "embed"):
        super().__init__()
        self.attention_dim = attention_dim
        self.attention_heads = attention_heads
        self.input_layer = input_layer
        self.dropout_rate = dropout_rate
        pos_enc = PositionalEncoding(attention_dim, positional_dropout_rate)
        if input_layer == "embed":
            self.embed = nn.Sequential(Embedding(odim, attention_dim),
                                       pos_enc)
        elif input_layer == "linear":
            # (B, L, odim) float inputs: Linear → LayerNorm → dropout →
            # ReLU, as the encoder's linear input layer
            self.embed_linear = Linear(odim, attention_dim)
            self.embed_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)
            self.embed_pos = pos_enc
        else:
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.decoders = nn.ModuleList([
            DecoderLayer(attention_dim, attention_heads, linear_units,
                         dropout_rate, self_attention_dropout_rate,
                         src_attention_dropout_rate)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)
        self.output_layer = Linear(attention_dim, odim)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        """tgt: (B, L) ids; tgt_mask: (B, L, L); memory: (B, T, D);
        memory_mask: (B, 1, T). Returns (B, L, odim) logits.  Under
        ``input_layer="linear"`` tgt is (B, L, odim) floats."""
        if self.input_layer == "embed":
            x = self.embed(tgt)
        else:
            x = self.embed_pos(torch.relu(dropout(
                self.embed_norm(self.embed_linear(tgt)), self.dropout_rate,
                self.training)))
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self.output_layer(self.after_norm(x))

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        H = self.attention_heads
        shape = (len(self.decoders), batch, max_len, H,
                 self.attention_dim // H)
        # projected keys and values: the compute dtype
        out = self.output_layer
        return {k: out.weight.new_zeros(shape, dtype=out.dtype)
                for k in ("k", "v")}

    def project_memory(self, memory) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-layer source-attention K/V, once per utterance: stacked
        (layers, B, T, H, dk)."""
        kv = [layer.src_attn.project_kv(memory, memory)
              for layer in self.decoders]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def forward_one_step(self, y_t, pos: int, cache, mem_k, mem_v, mem_mask):
        """y_t: (B,) last token ids; pos: step index; cache from
        ``init_cache`` (updated in place); mem_k/v from ``project_memory``;
        mem_mask: (B, 1, T).  Returns (log-probs (B, odim), cache)."""
        if self.input_layer != "embed":
            raise NotImplementedError("cached decode requires embed input")
        h = self.embed[0](y_t[:, None])                    # (B, 1, D)
        pe = torch.from_numpy(sinusoid_rows([pos], self.attention_dim))
        h = h * math.sqrt(self.attention_dim) + pe.to(h.device, h.dtype)
        for i, layer in enumerate(self.decoders):
            h = layer.step(h, pos, cache["k"][i], cache["v"][i], mem_k[i],
                           mem_v[i], mem_mask)
        y = self.output_layer(self.after_norm(h)[:, 0])
        return torch.log_softmax(y, dim=-1), cache
