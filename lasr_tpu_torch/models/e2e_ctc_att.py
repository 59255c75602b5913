"""Joint CTC/attention models (counterpart of
``lasr_tpu/models/e2e_ctc_att.py``).

The dict contract: ``forward`` takes ``(x, xlen, ys_in)`` and returns
``{att_out, ctc_out, hs_len}``; the decode hooks are ``encode``,
``ctc_logits``, ``decode_full`` and the cached ``decoder_*`` helpers.
Parameters carry the reference torch ``state_dict`` names
(``encoder.encoders.N.*``, ``ctc.1.*``, ...), so lighting-asr checkpoints
load unchanged.  ``forward`` runs in train mode too (dropout from the
generator of ``modules.dropout.dropout_generator``, BatchNorm batch
statistics); the decode hooks are eval-only.
"""

from __future__ import annotations

import torch
from torch import nn

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.modules.conformer import ConformerEncoder
from lasr_tpu_torch.modules.dropout import Dropout
from lasr_tpu_torch.modules.layers import Linear, set_compute_dtype
from lasr_tpu_torch.modules.transformer import Decoder, Encoder
from lasr_tpu_torch.utils.masks import target_mask


class CTCHead(nn.Sequential):
    """Dropout → Linear CTC projection (state_dict ``ctc.1.*``).

    ``domain_dim`` widens the projection input by a per-utterance tag
    (B, domain_dim), broadcast over time; omitted, zeros are used."""

    def __init__(self, idim: int, odim: int, dropout: float = 0.1,
                 domain_dim: int = 0):
        super().__init__(Dropout(dropout),
                         Linear(idim + domain_dim, odim))
        self.domain_dim = domain_dim

    def forward(self, hs, domain=None):
        if self.domain_dim:
            B, T = hs.shape[:2]
            if domain is None:
                tag = hs.new_zeros(B, T, self.domain_dim)
            else:
                tag = domain[:, None, :].to(hs.dtype).expand(
                    B, T, self.domain_dim)
            hs = torch.cat([hs, tag], dim=-1)
        return super().forward(hs)


class E2EBase(nn.Module):
    """Shared forward / decode-hook structure."""

    # whether CTCAttBeamDecoder searches this model
    joint_beam_search = True

    def _check_eval(self):
        if self.training:
            raise RuntimeError("the decode hooks run in eval mode; call "
                               ".eval() first")

    def forward(self, x, xlen, ys_in, ylen=None, domain=None):
        hs, hs_len = self.encoder(x, xlen)
        att_out = self.decoder(ys_in, target_mask(ys_in, ignore_id=-1), hs,
                               self._mem_mask(hs, hs_len))
        ctc_out = self.ctc(hs, domain=domain)
        return {"att_out": att_out, "ctc_out": ctc_out, "hs_len": hs_len}

    @staticmethod
    def _mem_mask(hs, hs_len):
        T = hs.shape[1]
        return (torch.arange(T, device=hs.device)[None, :]
                < hs_len[:, None])[:, None, :]

    def encode(self, x, xlen, solo_pad: bool = False, pos_offset=0):
        """``solo_pad=True``: decode-time semantics — each row's length and
        conv padding behave as if the utterance were encoded alone.
        ``pos_offset``: the absolute encoding's start position(s) in
        encoder frames, an int or a (B,) tensor (long-form windows); a
        no-op under ``rel_pos``."""
        self._check_eval()
        return self.encoder(x, xlen, solo_pad=solo_pad,
                            pos_offset=pos_offset)

    def ctc_logits(self, hs, domain=None):
        return self.ctc(hs, domain=domain)

    def decode_full(self, ys, hs, hs_len):
        return self.decoder(ys, target_mask(ys, ignore_id=-1), hs,
                            self._mem_mask(hs, hs_len))

    def decoder_init_cache(self, batch: int, max_len: int):
        return self.decoder.init_cache(batch, max_len)

    def decoder_project_memory(self, hs):
        return self.decoder.project_memory(hs)

    def decoder_step(self, y_t, pos, cache, mem_k, mem_v, mem_mask):
        return self.decoder.forward_one_step(y_t, pos, cache, mem_k, mem_v,
                                             mem_mask)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_dtype(dtype) -> torch.dtype:
    """The torch compute dtype a model's ``dtype`` argument names: ``None``
    (float32), a torch dtype, or a name such as ``"bfloat16"``,
    ``"jnp.bfloat16"`` or ``jnp.bfloat16`` itself (what the JAX package's
    configs and CLI pass); float32 and bfloat16 only."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        name = str(dtype)
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = getattr(dtype, "__name__", None) or getattr(dtype, "name", "")
    name = name.rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise NotImplementedError(
            f"compute dtype {dtype!r}: the port computes in float32 or "
            f"bfloat16")
    return _DTYPES[name]


class E2E_Transformer_CTC(E2EBase):
    """Transformer encoder + Transformer decoder + CTC head.

    Accepts every constructor kwarg of the JAX class.  The encoder's input
    layer is conv2d, linear, embed or None, the decoder's embed or linear
    (``modules.transformer``); ``encoder_remat`` recomputes each encoder
    block in the backward (``modules.remat``); ``encoder_act_sharding``
    (any value but None; the ``Trainer`` sets it under ``-seq_parallel``)
    splits the encoder's time axis over the grid's seq ranks, as the
    Conformer model does.
    ``device=None`` means CUDA (raises without a GPU); ``dtype`` is the compute dtype (float32, or bfloat16 with
    float32 parameters, gradients and optimizer state: the casts of
    ``modules.layers``, as ``lasr_tpu``'s ``dtype=jnp.bfloat16``)."""

    def __init__(self, idim: int = 13, odim: int = 26,
                 encoder_attention_dim: int = 256,
                 encoder_attention_heads: int = 4,
                 encoder_linear_units: int = 2048,
                 encoder_num_blocks: int = 12,
                 encoder_input_layer: str = "conv2d",
                 encoder_dropout_rate: float = 0.1,
                 encoder_attention_dropout_rate: float = 0.0,
                 decoder_attention_dim: int = 256,
                 decoder_attention_heads: int = 4,
                 decoder_linear_units: int = 2048,
                 decoder_num_block: int = 6,
                 decoder_input_layer: str = "embed",
                 decoder_dropout_rate: float = 0.1,
                 decoder_src_attention_dropout_rate: float = 0.0,
                 decoder_self_attention_dropout_rate: float = 0.0,
                 ctc_dropout: float = 0.1, encoder_remat: bool = False,
                 encoder_act_sharding=None, dtype=None, device=None):
        super().__init__()
        dtype = check_dtype(dtype)
        device = resolve_device(device)
        self.encoder = Encoder(
            idim=idim, attention_dim=encoder_attention_dim,
            attention_heads=encoder_attention_heads,
            linear_units=encoder_linear_units,
            num_blocks=encoder_num_blocks, dropout_rate=encoder_dropout_rate,
            positional_dropout_rate=encoder_dropout_rate,
            attention_dropout_rate=encoder_attention_dropout_rate,
            input_layer=encoder_input_layer, remat=encoder_remat,
            act_sharding=encoder_act_sharding is not None)
        self.decoder = Decoder(
            odim=odim, attention_dim=decoder_attention_dim,
            attention_heads=decoder_attention_heads,
            linear_units=decoder_linear_units, num_blocks=decoder_num_block,
            dropout_rate=decoder_dropout_rate,
            positional_dropout_rate=decoder_dropout_rate,
            self_attention_dropout_rate=decoder_self_attention_dropout_rate,
            src_attention_dropout_rate=decoder_src_attention_dropout_rate,
            input_layer=decoder_input_layer)
        self.ctc = CTCHead(encoder_attention_dim, odim, ctc_dropout)
        set_compute_dtype(self, dtype)
        self.to(device)
        self.eval()


class E2E_Conformer_CTC(E2EBase):
    """Conformer encoder + Transformer decoder + CTC head.

    Accepts every constructor kwarg of the JAX class.  The two kernel
    flags are honoured: ``encoder_rot_fold_pallas`` routes the encoder's
    rotated-fold attention through the rot kernels (eval, and training
    under ``encoder_pos_dropout_mode="rotated"``),
    ``encoder_use_pallas_attention`` its rel-pos attention through the rel
    kernels; ``encoder_pos_dropout_mode`` places positional dropout as in
    the JAX encoder.  ``encoder_remat`` recomputes each Conformer block
    in the backward (``modules.remat``; the kernels run again in the
    recompute).  ``encoder_ff_int8`` runs every encoder feed-forward's
    GEMMs through int8 (``ops.quant``; at eval too).
    ``encoder_pipeline_stages`` > 1 trains the encoder's blocks through
    GPipe's tick schedule over ``encoder_pipeline_microbatches``
    microbatches (``modules.pipeline``; across the grid's pipe ranks under
    ``-pipeline_parallel``), the parameters staying per block.
    ``encoder_act_sharding`` (any value but None; the ``Trainer`` sets it
    under ``-seq_parallel``) splits the encoder's time axis over the
    grid's seq ranks.  Knobs that only shape TPU training
    (``encoder_remat_attend``, ``encoder_scan_layers`` (with the pipeline
    it raises, as in ``lasr_tpu``), ``encoder_pipe_sharding``) are
    accepted and ignored.  ``device=None`` means CUDA (raises without a
    GPU); ``dtype`` is the compute dtype (float32, or bfloat16 with
    float32 parameters, gradients and BatchNorm statistics: the casts of
    ``modules.layers``, as ``lasr_tpu``'s ``dtype=jnp.bfloat16``)."""

    def __init__(self, idim: int = 13, odim: int = 26,
                 encoder_attention_dim: int = 256,
                 encoder_attention_heads: int = 4,
                 encoder_linear_units: int = 2048,
                 encoder_num_blocks: int = 12,
                 encoder_input_layer: str = "conv2d",
                 encoder_dropout_rate: float = 0.1,
                 encoder_attention_dropout_rate: float = 0.0,
                 encoder_pos_enc_layer_type: str = "abs_pos",
                 encoder_selfattention_layer_type: str = "selfattn",
                 encoder_use_cnn: bool = True, encoder_cnn_kernel: int = 31,
                 decoder_attention_dim: int = 256,
                 decoder_attention_heads: int = 4,
                 decoder_linear_units: int = 2048,
                 decoder_num_block: int = 6,
                 decoder_input_layer: str = "embed",
                 decoder_dropout_rate: float = 0.1,
                 decoder_src_attention_dropout_rate: float = 0.0,
                 decoder_self_attention_dropout_rate: float = 0.0,
                 ctc_dropout: float = 0.1, domain_dim: int = 0,
                 encoder_remat: bool = False,
                 encoder_use_pallas_attention: bool = False,
                 encoder_remat_attend: int = 0,
                 encoder_pos_dropout_mode: str = "table",
                 encoder_rot_fold_pallas: bool = False,
                 encoder_ff_int8: bool = False,
                 encoder_scan_layers: bool = False,
                 encoder_pipeline_stages: int = 1,
                 encoder_pipeline_microbatches: int = 0,
                 encoder_act_sharding=None, encoder_pipe_sharding=None,
                 dtype=None, device=None):
        super().__init__()
        if encoder_pipeline_stages > 1 and encoder_scan_layers:
            raise ValueError("pipeline_stages>1 already scans the layers "
                             "within each stage; unset scan_layers")
        dtype = check_dtype(dtype)
        device = resolve_device(device)
        self.encoder = ConformerEncoder(
            idim=idim, attention_dim=encoder_attention_dim,
            attention_heads=encoder_attention_heads,
            linear_units=encoder_linear_units,
            num_blocks=encoder_num_blocks, dropout_rate=encoder_dropout_rate,
            positional_dropout_rate=encoder_dropout_rate,
            attention_dropout_rate=encoder_attention_dropout_rate,
            input_layer=encoder_input_layer,
            pos_enc_layer_type=encoder_pos_enc_layer_type,
            selfattention_layer_type=encoder_selfattention_layer_type,
            use_cnn_module=encoder_use_cnn,
            cnn_module_kernel=encoder_cnn_kernel,
            use_pallas_attention=encoder_use_pallas_attention,
            rot_fold_pallas=encoder_rot_fold_pallas,
            pos_dropout_mode=encoder_pos_dropout_mode, remat=encoder_remat,
            ff_int8=encoder_ff_int8,
            pipeline_stages=encoder_pipeline_stages,
            pipeline_microbatches=encoder_pipeline_microbatches,
            act_sharding=encoder_act_sharding is not None)
        self.decoder = Decoder(
            odim=odim, attention_dim=decoder_attention_dim,
            attention_heads=decoder_attention_heads,
            linear_units=decoder_linear_units, num_blocks=decoder_num_block,
            dropout_rate=decoder_dropout_rate,
            positional_dropout_rate=decoder_dropout_rate,
            self_attention_dropout_rate=decoder_self_attention_dropout_rate,
            src_attention_dropout_rate=decoder_src_attention_dropout_rate,
            input_layer=decoder_input_layer)
        self.ctc = CTCHead(encoder_attention_dim, odim, ctc_dropout,
                           domain_dim)
        set_compute_dtype(self, dtype)
        self.to(device)
        self.eval()
