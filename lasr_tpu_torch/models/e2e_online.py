"""The streaming joint CTC/attention models (counterparts of
``E2E_Transformer_CTC_Online`` and ``E2E_Transformer_CTC_Univ_Dynamic`` in
``lasr_tpu/models/e2e_online.py``).

``ChunkEncoder`` + ``StreamDecoder`` + CTC head, with the reference's
constructor kwargs and state_dict names (``encoder.embed.*``,
``encoder.encoders.N.*``, ``decoder.decoders.N.src_attn.src_att_bias``,
...).  Decode hooks: ``encode`` / ``encode_online`` (the chunked forward;
``ref_tail`` selects the reference decoder's length convention),
``ctc_logits``, ``decoder_init_cache``, ``decoder_project_memory``,
``decoder_step`` (untruncated monotonic attention), ``decoder_step_online``
and ``decoder_step_ep`` (the online beam step).  ``forward`` is the dict
forward ``E2E_Loss`` takes, in train mode too (the chunked encoder's
layer-major forward, dropout and the source attention's sigmoid noise
drawn from ``modules.dropout``'s generator): the ``Trainer`` trains it.

``E2E_Transformer_CTC_Univ_Dynamic`` is the unified streaming / offline
model: a ``ParallelDynamicDualEncoder`` (both views of one Transformer
encoder in a 2B-row batch), the ``StreamDecoder`` over both views, and
the CTC head; ``forward`` gives both views' outputs and the online
view's source-attention maps for ``models.losses_univ.CTC_CE_Univ_Loss``.
Its ``encode`` takes the offline view (or, ``online=True``, the online
one), so the CTC-posterior decoders serve it (``ctc_greedy``, ``ctc_bs``,
``ctc_kenlm``, ``wfst``).  It has no joint CTC/attention beam search, as
``lasr_tpu``'s has none: ``CTCAttBeamDecoder`` raises on it.
"""

from __future__ import annotations

import torch

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.models.e2e_ctc_att import CTCHead, E2EBase, check_dtype
from lasr_tpu_torch.modules.layers import set_compute_dtype
from lasr_tpu_torch.modules.streaming import (ChunkEncoder,
                                              ParallelDynamicDualEncoder,
                                              StreamDecoder)
from lasr_tpu_torch.utils.masks import target_mask


class E2E_Transformer_CTC_Online(E2EBase):
    """Accepts every constructor kwarg of the JAX class.
    ``encoder_remat``, ``encoder_conv_once`` and
    ``encoder_layer_major_rows`` are the ``ChunkEncoder``'s memory knobs;
    ``encoder_layer_major=False`` (the JAX module's sequential chunk scan)
    gives the same numbers as the layer-major forward the port runs.
    ``device=None`` means CUDA (raises without a GPU); ``dtype`` is the
    compute dtype (float32, or bfloat16 with float32 parameters, as
    ``E2E_Transformer_CTC``)."""

    def __init__(self, idim: int = 13, odim: int = 26,
                 encoder_attention_dim: int = 256,
                 encoder_attention_heads: int = 4,
                 encoder_left_chunk: int = 64,
                 encoder_center_chunk: int = 64,
                 encoder_right_chunk: int = 64,
                 encoder_linear_units: int = 2048,
                 encoder_num_blocks: int = 12,
                 encoder_input_layer: str = "conv2d",
                 encoder_dropout_rate: float = 0.1,
                 encoder_attention_dropout_rate: float = 0.0,
                 decoder_attention_dim: int = 256,
                 decoder_self_attention_heads: int = 4,
                 decoder_src_attention_heads: int = 4,
                 decoder_linear_units: int = 2048,
                 decoder_num_block: int = 6,
                 decoder_input_layer: str = "embed",
                 decoder_dropout_rate: float = 0.1,
                 decoder_src_attention_dropout_rate: float = 0.0,
                 decoder_self_attention_dropout_rate: float = 0.0,
                 decoder_src_attention_bias_init: float = 0.0,
                 decoder_src_attention_sigmoid_noise: float = 1.0,
                 ctc_dropout: float = 0.1, encoder_remat: bool = False,
                 encoder_conv_once: bool = False,
                 encoder_layer_major: bool = True,
                 encoder_layer_major_rows: int = 0, dtype=None,
                 device=None):
        super().__init__()
        dtype = check_dtype(dtype)
        device = resolve_device(device)
        self.idim = idim
        self.encoder_center_chunk = encoder_center_chunk
        self.encoder_right_chunk = encoder_right_chunk
        self.encoder = ChunkEncoder(
            idim=idim, attention_dim=encoder_attention_dim,
            attention_heads=encoder_attention_heads,
            linear_units=encoder_linear_units,
            num_blocks=encoder_num_blocks,
            dropout_rate=encoder_dropout_rate,
            positional_dropout_rate=encoder_dropout_rate,
            attention_dropout_rate=encoder_attention_dropout_rate,
            input_layer=encoder_input_layer, left_len=encoder_left_chunk,
            cur_len=encoder_center_chunk, right_len=encoder_right_chunk,
            hop_len=encoder_center_chunk, remat=encoder_remat,
            layer_major=encoder_layer_major,
            layer_major_rows=encoder_layer_major_rows,
            conv_once=encoder_conv_once)
        self.decoder = StreamDecoder(
            odim=odim, attention_dim=decoder_attention_dim,
            self_attention_heads=decoder_self_attention_heads,
            src_attention_heads=decoder_src_attention_heads,
            linear_units=decoder_linear_units, num_blocks=decoder_num_block,
            dropout_rate=decoder_dropout_rate,
            positional_dropout_rate=decoder_dropout_rate,
            self_attention_dropout_rate=decoder_self_attention_dropout_rate,
            src_attention_dropout_rate=decoder_src_attention_dropout_rate,
            src_attention_bias_init=decoder_src_attention_bias_init,
            src_attention_sigmoid_noise=decoder_src_attention_sigmoid_noise,
            input_layer=decoder_input_layer)
        self.ctc = CTCHead(encoder_attention_dim, odim, ctc_dropout)
        set_compute_dtype(self, dtype)
        self.to(device)
        self.eval()

    def encode(self, x, xlen, solo_pad: bool = False, pos_offset=0):
        """The chunked forward.  ``solo_pad`` has nothing to act on here:
        every chunk is windowed and convolved alone, so a row's frames do
        not depend on the batch's padding; nor has ``pos_offset``, the
        chunks carrying their own positions (``lasr_tpu``'s ``encode``
        drops both for this encoder too)."""
        self._check_eval()
        return self.encoder(x, xlen)

    def encode_online(self, x, xlen, ref_tail: bool = False):
        self._check_eval()
        return self.encoder(x, xlen, ref_tail=ref_tail)

    def decoder_step_online(self, y_t, pos: int, cache, memory):
        return self.decoder.forward_one_step_online(y_t, pos, cache, memory)

    def decoder_step_ep(self, y_t, pos: int, cache, mem_k, mem_v,
                        mem_mask=None, parent=None, alive=None):
        """The online beam step (endpoints chained across same-parent
        siblings).  Returns (logp, cache, ep_stall)."""
        return self.decoder.forward_one_step_ep(y_t, pos, cache, mem_k,
                                                mem_v, mem_mask, parent,
                                                alive)


class E2E_Transformer_CTC_Univ_Dynamic(E2EBase):
    """Accepts every constructor kwarg of the JAX class.  ``device=None``
    means CUDA (raises without a GPU); ``dtype`` is the compute dtype
    (float32, or bfloat16 with float32 parameters)."""

    # lasr_tpu's CTCAttBeamDecoder fails on this model (its encode takes
    # no pos_offset, and it has no encode_online)
    joint_beam_search = False

    def __init__(self, idim: int = 13, odim: int = 26,
                 encoder_attention_dim: int = 256,
                 encoder_attention_heads: int = 4,
                 encoder_attention_chunk: int = 16,
                 encoder_attention_left: int = -1,
                 encoder_linear_units: int = 2048,
                 encoder_num_blocks: int = 12,
                 encoder_input_layer: str = "conv2d",
                 encoder_dropout_rate: float = 0.1,
                 encoder_attention_dropout_rate: float = 0.0,
                 decoder_attention_dim: int = 256,
                 decoder_self_attention_heads: int = 4,
                 decoder_src_attention_heads: int = 4,
                 decoder_linear_units: int = 2048,
                 decoder_num_block: int = 6,
                 decoder_input_layer: str = "embed",
                 decoder_dropout_rate: float = 0.1,
                 decoder_src_attention_dropout_rate: float = 0.0,
                 decoder_self_attention_dropout_rate: float = 0.0,
                 decoder_src_attention_bias_init: float = 0.0,
                 decoder_src_attention_sigmoid_noise: float = 1.0,
                 ctc_dropout: float = 0.1, dtype=None, device=None):
        super().__init__()
        dtype = check_dtype(dtype)
        device = resolve_device(device)
        self.idim = idim
        self.encoder = ParallelDynamicDualEncoder(
            idim=idim, attention_dim=encoder_attention_dim,
            attention_heads=encoder_attention_heads,
            attention_chunk=encoder_attention_chunk,
            attention_left=encoder_attention_left,
            linear_units=encoder_linear_units,
            num_blocks=encoder_num_blocks,
            dropout_rate=encoder_dropout_rate,
            positional_dropout_rate=encoder_dropout_rate,
            attention_dropout_rate=encoder_attention_dropout_rate,
            input_layer=encoder_input_layer)
        self.decoder = StreamDecoder(
            odim=odim, attention_dim=decoder_attention_dim,
            self_attention_heads=decoder_self_attention_heads,
            src_attention_heads=decoder_src_attention_heads,
            linear_units=decoder_linear_units, num_blocks=decoder_num_block,
            dropout_rate=decoder_dropout_rate,
            positional_dropout_rate=decoder_dropout_rate,
            self_attention_dropout_rate=decoder_self_attention_dropout_rate,
            src_attention_dropout_rate=decoder_src_attention_dropout_rate,
            src_attention_bias_init=decoder_src_attention_bias_init,
            src_attention_sigmoid_noise=decoder_src_attention_sigmoid_noise,
            input_layer=decoder_input_layer)
        self.ctc = CTCHead(encoder_attention_dim, odim, ctc_dropout)
        set_compute_dtype(self, dtype)
        self.to(device)
        self.eval()

    def forward(self, x, xlen, ys_in, ylen=None, domain=None):
        """Both views through the decoder and the CTC head as one 2B-row
        batch: ``{att_out_on, ctc_out_on, ali_out (the online view's
        per-layer source-attention maps, (B, layers·H, L, T)),
        att_out_off, ctc_out_off, hs_len}``, with ``att_out`` / ``ctc_out``
        the offline view's."""
        B = x.shape[0]
        hs_off, hs_on, hs_len = self.encoder(x, xlen)
        mem_mask = self._mem_mask(hs_off, hs_len)
        ys_mask = target_mask(ys_in, ignore_id=-1)
        att_all, attn = self.decoder(
            torch.cat([ys_in, ys_in]), torch.cat([ys_mask, ys_mask]),
            torch.cat([hs_off, hs_on]), torch.cat([mem_mask, mem_mask]),
            collect_attn=True)
        ctc_all = self.ctc(torch.cat([hs_off, hs_on]))
        return {"att_out_on": att_all[B:], "ctc_out_on": ctc_all[B:],
                "ali_out": attn[B:], "att_out_off": att_all[:B],
                "ctc_out_off": ctc_all[:B], "hs_len": hs_len,
                "att_out": att_all[:B], "ctc_out": ctc_all[:B]}

    def encode(self, x, xlen, online: bool = False, solo_pad: bool = False):
        """The offline view (or, ``online``, the chunk-masked one).
        ``solo_pad`` is accepted for the decoders' call and changes
        nothing, as in ``lasr_tpu``."""
        del solo_pad
        self._check_eval()
        if online:
            return self.encoder.forward_online(x, xlen)
        return self.encoder.forward_offline(x, xlen)

    def decoder_step_online(self, y_t, pos: int, cache, memory):
        return self.decoder.forward_one_step_online(y_t, pos, cache, memory)

    def decoder_step_ep(self, y_t, pos: int, cache, mem_k, mem_v,
                        mem_mask=None, parent=None, alive=None):
        return self.decoder.forward_one_step_ep(y_t, pos, cache, mem_k,
                                                mem_v, mem_mask, parent,
                                                alive)
