"""One-call inference API: ``ASRProcess(...)("test.wav") → (tokens, text)``
(counterpart of ``lasr_tpu/process/asrprocess.py``).

Builds tokenizer and model from the training config (class names written
for ``lasr_tpu`` or the reference resolve onto this package), loads a
reference-format checkpoint (a ``.pt``/``.ckpt`` file, the port's
checkpoints root or a directory of ``.ckpt`` files, averaged, EMA shadow
preferred), resamples the WAV to 16 kHz with the dataset's Kaiser
resampler, applies the decode config's ``audio_trans`` frontend on the
device, decodes and detokenizes.

Decode methods: those of the decode CLI (``decode.dispatch``):
``ctc_att`` (joint CTC/attention beam search; RNNLM shallow fusion with
``lm_rate``, ``lm_config`` and a ``.pt``/``.ckpt`` ``lm_path``; long-form
decoding with ``longform_segment_frames``), ``ctc_att_online`` (its
streaming form, for ``E2E_Transformer_CTC_Online``), ``ctc_greedy``,
``ctc_bs``, ``ctc_kenlm`` / ``ctc_kenlm_lexcoin`` and ``wfst``, whose
graph emits words: then the call returns (words, text).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import yaml

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.data import reader
from lasr_tpu_torch.data.resample import resample_kaiser
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.decode.dispatch import DecodeMethod
from lasr_tpu_torch.utils.registry import BaseConfig
from lasr_tpu_torch.utils.weights import (load_model_weights,
                                          load_reference_checkpoint)


class ASRProcess:
    def __init__(self, train_config: str, decode_config: str,
                 model_path: str, choose: str = "last", avg: int = 1,
                 device=None):
        self.device = resolve_device(device)
        with open(train_config) as f:
            tc = yaml.safe_load(f)
        with open(decode_config) as f:
            dc = yaml.safe_load(f)
        self.tokenizer = BaseConfig(**tc["tokenizer_config"]).generateExample()
        self.model = BaseConfig(**tc["model_config"]).generateExample(
            device=self.device)
        load_model_weights(self.model,
                           load_reference_checkpoint(model_path, choose, avg))

        cfg = dc.get("decode_config", {})
        trans = dc.get("test_data_config", {}).get("kwargs", {}).get(
            "audio_trans", ["norm", "fbank:80"])
        self.frontend = DeviceFrontend(
            [t for t in trans if not t.startswith("specaug")])
        self.decoder = DecodeMethod(self.model, self.tokenizer, cfg,
                                    self.device)
        self.method = self.decoder.method

    def frontend_wave(self, wav_path: str) -> Tuple[np.ndarray, int]:
        wav, sr = reader.read_audio(wav_path)
        wav = reader.average_channels(wav)
        if sr != 16000:
            wav = resample_kaiser(wav, sr, 16000)
        return np.asarray(wav, dtype=np.float32), len(wav)

    @torch.no_grad()
    def model_forward(self, wav: np.ndarray, n: int):
        """Token ids without sos/eos, or a ``wfst`` graph's word text."""
        feats, feat_len = self.frontend(
            torch.from_numpy(wav[None, :]).to(self.device),
            torch.tensor([n], dtype=torch.int32, device=self.device))
        hyp = self.decoder(feats, feat_len, 1)[0]
        return hyp.ids if hyp.text is None else hyp.text

    def backend(self, token_ids: List[int]) -> Tuple[List[str], str]:
        return self.tokenizer.decode(token_ids, no_special=True)

    def __call__(self, wav_path: str) -> Tuple[List[str], str]:
        wav, n = self.frontend_wave(wav_path)
        out = self.model_forward(wav, n)
        if isinstance(out, str):          # a wfst graph's word text
            return out.split(), out
        return self.backend(out)
