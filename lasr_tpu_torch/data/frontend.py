"""Device frontend: the YAML ``audio_trans`` chain as one function
(counterpart of ``lasr_tpu/data/frontend.py``), and ``pack_s2s``.

Supported: ``norm`` (peak normalize), ``fbank:N`` (Kaldi log-mel, N
bins) and ``specaug`` (train mode only, with the
``specaug:W=..,F=..,mF=..,T=..,mT=..`` knobs; its draws come from the
caller's ``torch.Generator``).  Wave-domain host transforms
(``avgchannel``, ``resample:16k``, ``soxspeed``) run at read time.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from lasr_tpu_torch.ops.fbank import (KaldiFbankConfig, fbank_num_frames,
                                      log_mel_fbank, peak_normalize)
from lasr_tpu_torch.ops.specaug import spec_augment

_SPECAUG_KNOBS = {"W": "max_time_warp", "F": "max_freq_width",
                  "mF": "n_freq_mask", "T": "max_time_width",
                  "mT": "n_time_mask"}


class DeviceFrontend:
    """Callable (wav, wav_len, generator=None, train=False, rows=None) →
    (feats, feat_len), on the device the inputs live on.  ``rows = (row0,
    global_wav_len)`` marks the batch as rows ``row0`` on of a global
    batch with those wave lengths: SpecAugment draws for the global rows
    and applies this batch's (``spec_augment``)."""

    def __init__(self, audio_trans: Sequence[str],
                 fbank: Optional[KaldiFbankConfig] = None,
                 specaug_kwargs: Optional[Dict] = None):
        self.audio_trans = list(audio_trans)
        self.specaug_kwargs = dict(specaug_kwargs or {})
        self.fbank_cfg = fbank or KaldiFbankConfig()
        self.feat_dim = None
        self._plan = []
        for trans in self.audio_trans:
            if trans == "norm":
                self._plan.append(("norm", None))
            elif m := re.fullmatch(r"fbank:(\d+)", trans):
                bins = int(m.group(1))
                self.fbank_cfg = replace(self.fbank_cfg, num_mel_bins=bins)
                self.feat_dim = bins
                self._plan.append(("fbank", None))
            elif m := re.fullmatch(r"specaug(?::(.+))?", trans):
                kw = {}
                for part in (m.group(1) or "").split(","):
                    if not part:
                        continue
                    k, _, v = part.partition("=")
                    if k not in _SPECAUG_KNOBS:
                        raise ValueError(
                            f"unknown specaug knob {k!r} in {trans!r} "
                            f"(expected {sorted(_SPECAUG_KNOBS)})")
                    kw[_SPECAUG_KNOBS[k]] = int(v)
                self._plan.append(("specaug", kw))
            elif trans in ("avgchannel", "resample:16k", "soxspeed"):
                continue
            else:
                raise ValueError(f"unknown audio transform {trans!r}")
        if self.feat_dim is None:
            raise ValueError("audio_trans must include an fbank:N stage")

    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False,
                 rows: Optional[Tuple[int, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not wav.is_floating_point():
            # int16 wire format, dequantized to the readers' float/32768
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        feats, feat_len = None, None
        for kind, arg in self._plan:
            if kind == "norm":
                wav = peak_normalize(wav)
            elif kind == "fbank":
                feats, feat_len = log_mel_fbank(wav, wav_len, self.fbank_cfg)
            elif kind == "specaug" and train:
                if feats is None:
                    raise ValueError("specaug must come after fbank")
                if generator is None:
                    raise ValueError("train-mode SpecAugment draws from a "
                                     "generator: pass generator=")
                global_rows = None
                if rows is not None:
                    global_len = torch.clamp(fbank_num_frames(
                        rows[1].to(feat_len.device), self.fbank_cfg),
                        max=feats.shape[1])
                    global_rows = (rows[0], global_len)
                feats = spec_augment(feats, feat_len, generator,
                                     rows=global_rows,
                                     **dict(self.specaug_kwargs, **arg))
        return feats, feat_len


def pack_s2s(token_id: torch.Tensor, token_len: torch.Tensor, sos: int = 1,
             eos: int = 2, ignore: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ys_in, att_label, ctc_label) from padded labels:
      ys_in     = [sos, y1..yL, eos, eos, ...]       (padded with eos)
      att_label = [y1..yL, eos, ignore, ignore, ...]  (padded with ignore)
      ctc_label = [y1..yL, ignore, ...]"""
    B, L = token_id.shape
    dev = token_id.device
    valid = torch.arange(L, device=dev)[None, :] < token_len[:, None]
    tokens = torch.where(valid, token_id, 0)
    ys_in = torch.cat([torch.full((B, 1), sos, dtype=token_id.dtype,
                                  device=dev),
                       torch.where(valid, tokens, eos)], dim=1)
    pos1 = torch.arange(L + 1, device=dev)[None, :]
    shifted = torch.cat([tokens, tokens.new_zeros(B, 1)], dim=1)
    att_label = torch.where(
        pos1 < token_len[:, None], shifted,
        torch.where(pos1 == token_len[:, None], eos, ignore).to(
            token_id.dtype))
    ctc_label = torch.where(valid, tokens, ignore)
    return ys_in, att_label, ctc_label
