"""lasr_tpu_torch — the PyTorch/CUDA port of lasr_tpu for NVIDIA Hopper.

The JAX package ``lasr_tpu`` is the reference: every module here mirrors
the module of the same path there, keeps the reference torch
``state_dict`` names (so lighting-asr checkpoints load unchanged), and is
held against it by the ``tests/test_torch_port_*.py`` parity tests.  The
TPU's Pallas kernels become hand-written CUDA C++ kernels for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use into ``_build/``.

This package imports torch, numpy and yaml only — never jax, flax or any
module of ``lasr_tpu``.

Layer map (same as lasr_tpu):
  utils/     config registry, masks, edit distance, the weight bridge /
             checkpoint loader
  ops/       fbank, SpecAugment, the CTC loss, and the attention kernels
             (CUDA + plain torch, forward and backward)
  modules/   nn.Modules (attention incl. monotonic, embeddings, conformer,
             Transformer encoder/decoder, the streaming chunk encoder,
             the dual-view encoders and the streaming decoder, the LSTM
             stack and RNN LM, generator-driven dropout, activation
             checkpointing that replays it, ...)
  models/    dict-in/dict-out joint CTC/attention models (Conformer,
             Transformer, streaming, the Univ dual-view model), losses
             (E2E_Loss, the Univ model's CTC_CE_Univ_Loss)
  data/      WAV reader, tokenizers, the frontend chain, pack_s2s
  train/     Adam/Noam (optax's update written out), EMA, the Trainer step
  parallel/  data parallelism over one process per GPU (torch.distributed)
  decode/    greedy CTC, the joint CTC/attention beam search (offline and
             online, RNNLM fusion, n-best), long-form decoding, the host
             searches (ctc_bs, the lexicon + ARPA decoder, WFST), the
             decode-method dispatch, the chunk-incremental
             StreamingRecognizer and its resumable beam search
  process/   one-call ASRProcess user API
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present — the port never carries on silently on the CPU; callers that
    want the CPU (the tests) pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lasr_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
