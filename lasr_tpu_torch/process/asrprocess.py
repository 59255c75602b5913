"""One-call inference API: ``ASRProcess(...)("test.wav") → (tokens, text)``
(counterpart of ``lasr_tpu/process/asrprocess.py``).

Builds tokenizer and model from the training config (class names written
for ``lasr_tpu`` or the reference resolve onto this package), loads a
reference-format checkpoint (a ``.pt``/``.ckpt`` file, the port's
checkpoints root or a directory of ``.ckpt`` files, averaged, EMA shadow
preferred), resamples the WAV to 16 kHz with the dataset's Kaiser
resampler, applies the decode config's ``audio_trans`` frontend on the
device, decodes and detokenizes.

Decode methods: ``ctc_att`` (joint CTC/attention beam search),
``ctc_att_online`` (its streaming form, for ``E2E_Transformer_CTC_Online``)
and ``ctc_greedy``; the others raise until they are ported.
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
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.greedy import ctc_greedy_decode
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
        self.method = cfg.get("decode_method", "ctc_att")
        if float(cfg.get("lm_rate") or 0.0) > 0.0 and cfg.get("lm_path"):
            raise NotImplementedError("LM shallow fusion is not ported yet")
        if int(cfg.get("longform_segment_frames", 0)) > 0:
            raise NotImplementedError("long-form decoding is not ported yet")
        self.decoder = None
        if self.method in ("ctc_att", "ctc_att_online"):
            self.decoder = CTCAttBeamDecoder(
                self.model, sos=self.tokenizer.ID_VALUE_SOS,
                eos=self.tokenizer.ID_VALUE_EOS,
                beam=cfg.get("beam", 10), ctc_beam=cfg.get("ctc_beam", 15),
                ctc_weight=cfg.get("ctc_weight", 0.5),
                nbest=int(cfg.get("nbest", 1)),
                online=self.method == "ctc_att_online", device=self.device)
        elif self.method != "ctc_greedy":
            raise NotImplementedError(
                f"decode_method {self.method!r} is not ported yet "
                f"(ctc_att, ctc_att_online and ctc_greedy are)")

    def frontend_wave(self, wav_path: str) -> Tuple[np.ndarray, int]:
        wav, sr = reader.read_audio(wav_path)
        wav = reader.average_channels(wav)
        if sr != 16000:
            wav = resample_kaiser(wav, sr, 16000)
        return np.asarray(wav, dtype=np.float32), len(wav)

    @torch.no_grad()
    def model_forward(self, wav: np.ndarray, n: int) -> List[int]:
        feats, feat_len = self.frontend(
            torch.from_numpy(wav[None, :]).to(self.device),
            torch.tensor([n], dtype=torch.int32, device=self.device))
        if self.decoder is not None:
            return self.decoder(feats, feat_len).best_ids(0)
        hs, hs_len = self.model.encode(feats, feat_len, solo_pad=True)
        return ctc_greedy_decode(self.model.ctc_logits(hs), hs_len)[0]

    def backend(self, token_ids: List[int]) -> Tuple[List[str], str]:
        return self.tokenizer.decode(token_ids, no_special=True)

    def __call__(self, wav_path: str) -> Tuple[List[str], str]:
        wav, n = self.frontend_wave(wav_path)
        return self.backend(self.model_forward(wav, n))
