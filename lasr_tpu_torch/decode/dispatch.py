"""Every ``decode_method`` of a decode config, behind one call: the
dispatch that ``lasr_tpu``'s ``bin/decode.py`` and ``ASRProcess`` each
spell out, shared here by the port's decode CLI and ``ASRProcess``.

  - ``ctc_att`` / ``ctc_att_online``: the joint CTC/attention beam search
    on the device, with RNNLM shallow fusion (``lm_rate``, ``lm_config``,
    ``lm_path``; ``decode.lm.build_lm``) and ``nbest`` hypotheses;
    ``longform_segment_frames`` > 0 (``ctc_att`` only) decodes each
    utterance alone through ``LongFormCTCAttDecoder`` (1-best);
  - ``ctc_greedy``: best path of the CTC posteriors;
  - the host searches over the CTC log-posteriors copied to the host once
    per batch: ``ctc_bs`` (prefix beam search, with the RNNLM when one is
    configured), ``ctc_kenlm`` / ``ctc_kenlm_lexcoin`` (lexicon + ARPA
    word LM) and ``wfst`` (an OpenFst graph; it emits word text, 1-best).

The YAML keys and their defaults are ``lasr_tpu``'s.
"""

from __future__ import annotations

import logging
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.greedy import ctc_greedy_decode
from lasr_tpu_torch.decode.lm import build_lm


class Hypothesis(NamedTuple):
    """One utterance's result: token ids (without sos/eos), or the word
    text a ``wfst`` graph emits (``ids`` None), and the n-best list
    ``[(ids, score)]`` best first (empty where the method has none)."""
    ids: Optional[List[int]]
    text: Optional[str]
    nbest: List[Tuple[List[int], float]]


class DecodeMethod:
    """The ``decode_config`` block ``cfg`` over ``model`` on ``device``
    (a resolved torch device).  ``nbest`` is the number of hypotheses
    each result lists (1 for long-form and ``wfst``, which warn)."""

    def __init__(self, model, tokenizer, cfg: dict, device):
        self.model = model
        self.method = method = cfg.get("decode_method", "ctc_att")
        self.nbest = int(cfg.get("nbest", 1))
        self.beam = self.longform = self.host = None
        lm, lm_weight = build_lm(cfg, device=device)
        if method in ("ctc_att", "ctc_att_online"):
            self.beam = CTCAttBeamDecoder(
                model, sos=tokenizer.ID_VALUE_SOS, eos=tokenizer.ID_VALUE_EOS,
                beam=cfg.get("beam", 10), ctc_beam=cfg.get("ctc_beam", 15),
                ctc_weight=cfg.get("ctc_weight", 0.5), nbest=self.nbest,
                lm=lm, lm_weight=lm_weight,
                online=method == "ctc_att_online", device=device)
            seg = int(cfg.get("longform_segment_frames", 0))
            if seg > 0 and method == "ctc_att":
                from lasr_tpu_torch.decode.longform import \
                    LongFormCTCAttDecoder
                self.longform = LongFormCTCAttDecoder(
                    self.beam, segment_frames=seg,
                    encoder_window_frames=int(cfg.get(
                        "longform_encoder_window_frames", 0)),
                    encoder_halo_frames=int(cfg.get(
                        "longform_encoder_halo_frames", 128)),
                    device=device)
                self._one_best("longform")
        elif method == "ctc_bs":
            from lasr_tpu_torch.decode.ctc_bs import CTC_Decoder
            self.host = CTC_Decoder(
                beam_size=cfg.get("beam", 10),
                ctc_beam=cfg.get("ctc_beam", 15),
                sos=tokenizer.ID_VALUE_SOS, rnn_lm=lm, lm_rate=lm_weight)
        elif method in ("ctc_kenlm", "ctc_kenlm_lexcoin"):
            from lasr_tpu_torch.decode.ctc_w2l import CTC_KenLM_Decoder
            self.host = CTC_KenLM_Decoder(
                beam_size=cfg.get("beam", 10),
                beam_threshold=cfg.get("beam_threshold", 25.0),
                lexicon=cfg["lexicon"], tokens_dict=cfg["tokens_dict"],
                kenlm_model=cfg["kenlm_model"],
                sos="<eos>", blk="<blank>", unk="<unk>", sil=cfg.get("sil"),
                lm_weight=cfg.get("lm_weight", 2.0),
                word_score=cfg.get("word_score", -1.0),
                unk_score=-math.inf, sil_score=cfg.get("sil_score", 0.0),
                log_add=bool(cfg.get("log_add", False)),
                beam_size_token=cfg.get("beam_size_token"))
        elif method == "wfst":
            from lasr_tpu_torch.decode.wfst import Kaldi_Decoder
            self.host = Kaldi_Decoder(
                beam=cfg.get("wfst_beam", 16.0),
                max_active=cfg.get("max_active", 7000),
                mdl=cfg.get("mdl"), fst=cfg["fst"], word=cfg["word"],
                acoustic_scale=cfg.get("acoustic_scale", 0.1))
            self._one_best("wfst")
        elif method != "ctc_greedy":
            raise ValueError(f"unknown decode_method {method!r}")

    def _one_best(self, what: str) -> None:
        if self.nbest > 1:
            logging.warning("%s decoding emits 1-best only; ignoring "
                            "nbest=%d", what, self.nbest)
            self.nbest = 1

    @torch.no_grad()
    def __call__(self, feats, feat_len, n: int) -> List[Hypothesis]:
        """The first ``n`` rows of a (B, T_in, D) feature batch."""
        if self.longform is not None:
            return [Hypothesis(self.longform(feats[b: b + 1],
                                             feat_len[b: b + 1])[0],
                               None, []) for b in range(n)]
        if self.beam is not None:
            hyps = self.beam(feats, feat_len)
            return [Hypothesis(hyps.best_ids(b), None,
                               hyps.nbest_ids(b)[: self.nbest])
                    for b in range(n)]
        hs, hs_len = self.model.encode(feats, feat_len, solo_pad=True)
        logits = self.model.ctc_logits(hs)
        if self.host is None:
            return [Hypothesis(ids, None, [])
                    for ids in ctc_greedy_decode(logits, hs_len)[:n]]
        lpz = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        lens = hs_len.cpu().numpy()
        return [self._host_search(lpz[b, : int(lens[b])]) for b in range(n)]

    def _host_search(self, lpz: np.ndarray) -> Hypothesis:
        if self.method == "wfst":
            return Hypothesis(None, self.host.decode_loglike(lpz)["text"], [])
        cands = self.host.decode_problike(lpz)[: self.nbest]
        if self.method == "ctc_bs":       # strip the leading sos
            cands = [(list(pfx[1:]), sc) for pfx, sc in cands]
        return Hypothesis(cands[0][0] if cands else [], None, cands)
