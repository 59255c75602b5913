"""Device frontend: the YAML ``audio_trans`` chain as one function
(counterpart of ``lasr_tpu/data/frontend.py``).

Supported: ``norm`` (peak normalize) and ``fbank:N`` (Kaldi log-mel, N
bins).  ``specaug`` is accepted in the chain and is a no-op at inference;
train-mode SpecAugment belongs to the training slice and raises for now.
Wave-domain host transforms (``avgchannel``, ``resample:16k``,
``soxspeed``) run at read time.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Optional, Sequence, Tuple

import torch

from lasr_tpu_torch.ops.fbank import (KaldiFbankConfig, log_mel_fbank,
                                      peak_normalize)


class DeviceFrontend:
    """Callable (wav, wav_len, train=False) → (feats, feat_len), on the
    device the inputs live on."""

    def __init__(self, audio_trans: Sequence[str],
                 fbank: Optional[KaldiFbankConfig] = None):
        self.audio_trans = list(audio_trans)
        self.fbank_cfg = fbank or KaldiFbankConfig()
        self.feat_dim = None
        self._plan = []
        for trans in self.audio_trans:
            if trans == "norm":
                self._plan.append("norm")
            elif m := re.fullmatch(r"fbank:(\d+)", trans):
                bins = int(m.group(1))
                self.fbank_cfg = replace(self.fbank_cfg, num_mel_bins=bins)
                self.feat_dim = bins
                self._plan.append("fbank")
            elif re.fullmatch(r"specaug(?::(.+))?", trans):
                self._plan.append("specaug")
            elif trans in ("avgchannel", "resample:16k", "soxspeed"):
                continue
            else:
                raise ValueError(f"unknown audio transform {trans!r}")
        if self.feat_dim is None:
            raise ValueError("audio_trans must include an fbank:N stage")

    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor,
                 train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        if not wav.is_floating_point():
            # int16 wire format, dequantized to the readers' float/32768
            wav = wav.to(torch.float32) * (1.0 / 32768.0)
        feats, feat_len = None, None
        for kind in self._plan:
            if kind == "norm":
                wav = peak_normalize(wav)
            elif kind == "fbank":
                feats, feat_len = log_mel_fbank(wav, wav_len, self.fbank_cfg)
            elif kind == "specaug" and train:
                raise NotImplementedError(
                    "train-mode SpecAugment is not ported yet (training "
                    "slice, ROADMAP queue A)")
        return feats, feat_len
