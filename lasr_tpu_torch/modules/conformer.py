"""Conformer encoder (counterpart of ``lasr_tpu/modules/conformer.py``).

The blocks ``E2E_Conformer_CTC`` builds: pre-norm (LayerNorm eps 1e-12)
MHA(+rel pos) → conv module → feed-forward (swish) → final norm, each
branch dropped out before its residual add in training, without macaron
feed-forward (the model hard-codes ``macaron_style=False``).  The
ConvolutionModule is pointwise → GLU → depthwise → BatchNorm (eps 1e-5;
Flax's batch statistics in training, see ``FlaxBatchNorm1d``) → swish →
pointwise.

Sequence parallelism (``act_sharding`` with a grid of several seq ranks,
``parallel.dist``): the encoder pads its input as ``lasr_tpu`` does, so
that the encoder's length divides the seq ranks (``seq_pad_input``), runs
the input layer whole on every seq rank, gives each rank its rows of the
time axis for the blocks (``dist.seq_split``) and gathers them after the
after-norm.  Inside the blocks the attention gathers keys and values, the
depthwise conv the GLU output (``dist.seq_gather``: a rank's rows need
(K-1)/2 frames of each neighbour), BatchNorm sums over data x seq, and
dropout draws the whole time axis's mask and keeps the rank's rows, so
an S-rank step equals the one-process step on the padded batch.
``pipeline_stages`` > 1 runs the blocks through ``modules.pipeline``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.attention import (
    MultiHeadedAttention, RelPositionMultiHeadedAttention,
    build_skewed_pos_table)
from lasr_tpu_torch.modules.dropout import dropout, time_shard
from lasr_tpu_torch.modules.embedding import (PositionalEncoding,
                                              RelPositionalEncoding,
                                              ScaledPositionalEncoding)
from lasr_tpu_torch.modules.feed_forward import PositionwiseFeedForward
from lasr_tpu_torch.modules.layers import Computes, Conv1d, LayerNorm, Linear
from lasr_tpu_torch.modules.pipeline import run_pipeline
from lasr_tpu_torch.modules.remat import checkpointed, recomputing
from lasr_tpu_torch.modules.subsampling import Conv2dSubsampling
from lasr_tpu_torch.modules.transformer import (LAYERNORM_EPS,
                                                seq_pad_input,
                                                time_split_blocks)
from lasr_tpu_torch.parallel import dist


class FlaxBatchNorm1d(Computes, nn.BatchNorm1d):
    """BatchNorm over (B, C, T) with the reference state_dict names and
    Flax's training semantics (``lasr_tpu`` ``nn.BatchNorm(momentum=0.9)``):
    the statistics are taken over every B×T frame, padding included, the
    variance is the biased E[x²] - E[x]² (clamped at 0), and the running
    statistics move as ``ra = 0.9·ra + 0.1·batch_stat``, the running
    variance with the biased batch variance (torch's BatchNorm keeps the
    unbiased one).  Eval mode normalizes with the running statistics.
    Statistics, running averages and the affine map are float32 whatever
    the compute dtype; the result is cast to it (Flax's policy).

    Under a process group of several data ranks the statistics are the
    global batch's, as ``lasr_tpu``'s one program on a data axis takes them:
    (Σx, Σx², count) summed over the ranks by a differentiable all-reduce,
    whose backward carries the cross-rank terms; the running statistics
    stay identical on every rank.  (``nn.SyncBatchNorm`` moves
    ``running_var`` with the unbiased variance.)  Under a seq split the
    sums run over the data x seq ranks.  A remat recompute
    (``modules.remat``) normalizes again but moves nothing."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.dtype)
        group = "data" if dist.current_seq_split() is None else "data_seq"
        if dist.group_size(group) > 1:
            C = x.shape[1]
            sums = dist.all_reduce_sum(torch.cat([
                x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)),
                x.new_full((1,), x.shape[0] * x.shape[2])]), group)
            mean, sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        else:
            mean, sq = x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))
        var = torch.clamp(sq - mean * mean, min=0.0)
        if not recomputing():
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None]) * mul[:, None]
                + self.bias[:, None]).to(self.dtype)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 31):
        super().__init__()
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     padding=(kernel_size - 1) // 2,
                                     groups=channels)
        self.norm = FlaxBatchNorm1d(channels, eps=1e-5)
        self.pointwise_conv2 = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, zero_mask=None) -> torch.Tensor:
        """x: (B, T, C) → (B, T, C).  ``zero_mask`` (B, T) bool, True =
        valid: zeroes the GLU output at invalid frames before the depthwise
        conv, so a batched decode sees the zeros the conv's own padding
        gives an utterance encoded alone."""
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        if zero_mask is not None:
            h = h.masked_fill(~zero_mask[:, None, :], 0.0)
        split = dist.current_seq_split()
        if split is None:
            h = self.depthwise_conv(h)
        else:
            # the rank's rows and (K-1)/2 frames on each side, from the
            # whole sequence (zeros past its ends: the conv's padding)
            conv = self.depthwise_conv
            pad = conv.padding[0]
            whole = F.pad(dist.seq_gather(h, 2), (pad, pad))
            window = whole[..., split.offset:split.offset + split.local
                           + 2 * pad]
            h = F.conv1d(*conv._cast(window, conv.weight, conv.bias),
                         groups=conv.groups)
        h = self.norm(h)
        return self.pointwise_conv2(F.silu(h)).transpose(1, 2)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 selfattention_layer_type: str = "selfattn",
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 use_pallas_attention: bool = False, rot_fold: bool = False,
                 rot_fold_pallas: bool = False, rot_fold_train: bool = False,
                 pos_dropout_rate: float = 0.0, ff_int8: bool = False):
        super().__init__()
        self.rel = selfattention_layer_type == "rel_selfattn"
        self.dropout_rate = dropout_rate
        self.norm_mha = LayerNorm(size, eps=LAYERNORM_EPS)
        if self.rel:
            self.self_attn = RelPositionMultiHeadedAttention(
                attention_heads, size, attention_dropout_rate,
                use_pallas=use_pallas_attention, rot_fold=rot_fold,
                rot_fold_pallas=rot_fold_pallas,
                rot_fold_train=rot_fold_train,
                pos_dropout_rate=pos_dropout_rate)
        elif selfattention_layer_type == "selfattn":
            self.self_attn = MultiHeadedAttention(attention_heads, size,
                                                  attention_dropout_rate)
        else:
            raise ValueError(
                f"unknown selfattention_layer_type {selfattention_layer_type}")
        self.use_cnn_module = use_cnn_module
        if use_cnn_module:
            self.norm_conv = LayerNorm(size, eps=LAYERNORM_EPS)
            self.conv_module = ConvolutionModule(size, cnn_module_kernel)
            self.norm_final = LayerNorm(size, eps=LAYERNORM_EPS)
        self.norm_ff = LayerNorm(size, eps=LAYERNORM_EPS)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, dropout_rate, activation=F.silu,
            int8=ff_int8)

    def _drop(self, x):
        return dropout(x, self.dropout_rate, self.training, time_shard(1))

    def forward(self, x, mask=None, pos_emb=None, conv_zero_mask=None,
                pos_table=None):
        y = self.norm_mha(x)
        if self.rel:
            x = x + self._drop(self.self_attn(y, y, y, pos_emb, mask,
                                              pos_table=pos_table))
        else:
            x = x + self._drop(self.self_attn(y, y, y, mask))
        if self.use_cnn_module:
            x = x + self._drop(self.conv_module(self.norm_conv(x),
                                                conv_zero_mask))
        x = x + self._drop(self.feed_forward(self.norm_ff(x)))
        if self.use_cnn_module:
            x = self.norm_final(x)
        return x


class ConformerEncoder(nn.Module):
    """Conformer encoder stack.

    ``input_layer``: ``"conv2d"`` (the subsampling, T → T/4), ``"linear"``
    (Linear → LayerNorm → dropout, then the positional encoding; state_dict
    ``embed_linear.*`` / ``embed_norm.*``) or None (the positional
    encoding alone).  ``pos_enc_layer_type``: ``"abs_pos"``,
    ``"scaled_abs_pos"`` (``ScaledPositionalEncoding``, its ``alpha`` at
    ``embed.pos_enc.alpha`` under conv2d, else ``embed_pos.alpha``) or
    ``"rel_pos"``.

    ``pos_dropout_mode`` (rel_pos only) places positional dropout as the
    JAX encoder does: ``"table"`` on the (1, 2T-1, D) table (the
    reference's semantics; training scores through the skewed-table fold
    for T <= 1024, else the per-layer rel-shift), ``"rotated"`` on the
    rotated position-query u, so training runs the rotated fold (and, with
    ``rot_fold_pallas``, the rot kernels).  ``remat`` recomputes each
    block's activations in the backward (``modules.remat``).
    ``ff_int8`` runs every feed-forward's GEMMs through int8
    (``ops.quant``); ``pipeline_stages`` / ``pipeline_microbatches`` and
    ``act_sharding`` are in the module docstring."""

    def __init__(self, idim: int, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = "conv2d",
                 pos_enc_layer_type: str = "abs_pos",
                 selfattention_layer_type: str = "selfattn",
                 use_cnn_module: bool = True, cnn_module_kernel: int = 31,
                 use_pallas_attention: bool = False, rot_fold: bool = True,
                 rot_fold_pallas: bool = False,
                 pos_dropout_mode: str = "table", remat: bool = False,
                 ff_int8: bool = False, pipeline_stages: int = 1,
                 pipeline_microbatches: int = 0, act_sharding: bool = False):
        super().__init__()
        if pipeline_stages > 1 and num_blocks % pipeline_stages:
            raise ValueError(f"pipeline: num_layers={num_blocks} not "
                             f"divisible by stages={pipeline_stages}")
        self.remat = remat
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.act_sharding = act_sharding
        if input_layer not in ("conv2d", "linear", None):
            raise ValueError(f"unknown input_layer: {input_layer}")
        self.input_layer = input_layer
        self.dropout_rate = dropout_rate
        if pos_dropout_mode not in ("table", "rotated"):
            raise ValueError(f"unknown pos_dropout_mode: {pos_dropout_mode!r}")
        self.rel = pos_enc_layer_type == "rel_pos"
        if pos_dropout_mode == "rotated" and not (self.rel and rot_fold):
            raise ValueError("pos_dropout_mode='rotated' needs "
                             "pos_enc_layer_type='rel_pos' with rot_fold "
                             "enabled")
        self.rot_fold = rot_fold and self.rel
        self.table_fold = (self.rel and not use_pallas_attention
                           and pos_dropout_mode == "table")
        rotated = pos_dropout_mode == "rotated"
        if self.rel:
            if selfattention_layer_type != "rel_selfattn":
                raise ValueError("rel_pos needs rel_selfattn")
            pos_enc = RelPositionalEncoding(attention_dim,
                                            positional_dropout_rate,
                                            drop_pos=not rotated)
        elif pos_enc_layer_type == "abs_pos":
            pos_enc = PositionalEncoding(attention_dim,
                                         positional_dropout_rate)
        elif pos_enc_layer_type == "scaled_abs_pos":
            pos_enc = ScaledPositionalEncoding(attention_dim,
                                               positional_dropout_rate)
        else:
            raise ValueError(
                f"unknown pos_enc_layer: {pos_enc_layer_type}")
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(idim, attention_dim, pos_enc,
                                           dropout_rate)
        else:
            if input_layer == "linear":
                self.embed_linear = Linear(idim, attention_dim)
                self.embed_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)
            self.embed_pos = pos_enc
        self.encoders = nn.ModuleList([
            ConformerEncoderLayer(
                attention_dim, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, selfattention_layer_type,
                use_cnn_module, cnn_module_kernel,
                use_pallas_attention=use_pallas_attention,
                rot_fold=self.rot_fold, rot_fold_pallas=rot_fold_pallas,
                rot_fold_train=rotated,
                pos_dropout_rate=positional_dropout_rate if rotated else 0.0,
                ff_int8=ff_int8)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(attention_dim, eps=LAYERNORM_EPS)

    def embed_input(self, x, x_len, solo_len: bool, offset):
        """The input layer and the positional encoding: (out, lengths), out
        being h or the relative encoding's (h, pos_emb) pair."""
        if self.input_layer == "conv2d":
            return self.embed(x, x_len, solo_len=solo_len, offset=offset)
        if self.input_layer == "linear":
            x = dropout(self.embed_norm(self.embed_linear(x)),
                        self.dropout_rate, self.training)
        if self.rel:
            return self.embed_pos(x), x_len
        return self.embed_pos(x, offset), x_len

    def forward(self, x, x_len, solo_pad: bool = False, pos_offset=0):
        """x: (B, T, idim), x_len: (B,) → (hs (B, T', D), hs_len (B,)).

        ``solo_pad``: decode-time semantics — per-row lengths as if each
        utterance were encoded alone, and zeros past the valid length
        before the conv module.  ``pos_offset``: the absolute encoding's
        start position(s) in encoder frames, an int or a (B,) tensor; a
        no-op under ``rel_pos`` (translation-invariant)."""
        split = self.act_sharding and dist.seq_size() > 1
        len_cap = None
        if split:
            x, len_cap = seq_pad_input(x, self.input_layer == "conv2d",
                                       dist.seq_size())
        out, h_len = self.embed_input(x, x_len, solo_pad,
                                      0 if self.rel else pos_offset)
        h, pos_emb = out if self.rel else (out, None)
        if len_cap is not None:
            h_len = torch.clamp(h_len, max=len_cap)
        T = h.shape[1]
        pad = torch.arange(T, device=h.device)[None, :] < h_len[:, None]
        mask = pad[:, None, :]
        conv_zero = pad if solo_pad else None
        # the skewed table, once per forward, where the layers take the
        # table fold: training, or eval without the rotated fold
        pos_table = None
        if (self.table_fold and (self.training or not self.rot_fold)
                and pos_emb.shape[1] == 2 * T - 1 and T <= 1024):
            pos_table = build_skewed_pos_table(pos_emb)

        def blocks(h, conv_zero):
            if self.pipeline_stages > 1:
                return run_pipeline(self, h, mask, conv_zero, pos_emb,
                                    pos_table)
            for layer in self.encoders:
                if self.remat:
                    h = checkpointed(layer, h, mask, pos_emb, conv_zero,
                                     pos_table)
                else:
                    h = layer(h, mask, pos_emb, conv_zero, pos_table)
            return h

        return time_split_blocks(blocks, h, conv_zero, self.after_norm,
                                 split), h_len
