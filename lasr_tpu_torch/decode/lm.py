"""Decode-time language-model loading (counterpart of
``lasr_tpu/decode/lm.py``).

The LM is described by the decode config's optional ``lm_config`` block
(the ``{name, kwargs}`` schema of every component; the name
``lasr_tpu.modules.rnn:RNNCellStack`` resolves onto
``lasr_tpu_torch.modules.rnn``) and ``lm_path``; shallow fusion is on
when both are present and ``lm_rate`` > 0.

Checkpoint format: ``lm_path`` is what ``utils.weights.
load_reference_checkpoint`` reads — a ``.pt``/``.ckpt`` state_dict file
of the port's ``RNNCellStack`` (``utils.weights.rnnlm_flax_to_state_dict``
writes one from ``lasr_tpu``'s parameters) or a port checkpoints root.
``lasr_tpu``'s ``lm_path`` is an orbax directory, which this package
cannot read yet (ROADMAP A2, reading ``lasr_tpu``'s orbax checkpoints):
given one, it raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.modules.rnn import RNNLM
from lasr_tpu_torch.utils.registry import BaseConfig
from lasr_tpu_torch.utils.weights import (load_model_weights,
                                          load_reference_checkpoint)


def _has_checkpoints(path: str) -> bool:
    return any(os.path.isdir(d) and any(n.endswith(".ckpt")
                                        for n in os.listdir(d))
               for d in (path, os.path.join(path, "last")))


def load_lm_state_dict(lm_path: str):
    """The LM's state_dict from a checkpoint file or a checkpoints root
    (its newest ``last`` checkpoint, as ``lasr_tpu`` restores it)."""
    if os.path.isdir(lm_path) and not _has_checkpoints(lm_path):
        raise NotImplementedError(
            f"lm_path {lm_path!r} is a directory without .ckpt files (an "
            f"orbax checkpoint of lasr_tpu?); the port reads a .pt/.ckpt "
            f"state_dict or its checkpoints root; reading orbax is ROADMAP "
            f"A2")
    return load_reference_checkpoint(lm_path, "last", avg=1)


def build_lm(decode_cfg: dict, device=None
             ) -> Tuple[Optional[RNNLM], float]:
    """(RNNLM | None, lm_weight) from a decode-config block.

    Fusion needs ``lm_rate`` > 0, ``lm_config`` and ``lm_path``; a
    positive rate without a configured LM warns and gives weight 0.
    ``device=None`` means CUDA (raises without a GPU)."""
    device = resolve_device(device)
    lm_rate = float(decode_cfg.get("lm_rate") or 0.0)
    lm_conf = decode_cfg.get("lm_config")
    lm_path = decode_cfg.get("lm_path")
    if lm_rate <= 0.0:
        return None, 0.0
    if not lm_conf or not lm_path:
        logging.warning("lm_rate=%s but lm_config/lm_path missing — "
                        "decoding without LM fusion", lm_rate)
        return None, 0.0
    module = BaseConfig(**lm_conf).generateExample(device=device)
    load_model_weights(module, load_lm_state_dict(lm_path))
    return RNNLM(module), lm_rate
