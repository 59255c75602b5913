"""Decode-time language-model loading (counterpart of
``lasr_tpu/decode/lm.py``).

The LM is described by the decode config's optional ``lm_config`` block
(the ``{name, kwargs}`` schema of every component; the name
``lasr_tpu.modules.rnn:RNNCellStack`` resolves onto
``lasr_tpu_torch.modules.rnn``) and ``lm_path``; shallow fusion is on
when both are present and ``lm_rate`` > 0.

Checkpoint format: ``lm_path`` is read as ``lasr_tpu`` reads it: an
orbax checkpoints root of ``lasr_tpu``'s Trainer (its newest ``last``
step, the EMA shadow preferred) or one orbax checkpoint directory (its
``params``), mapped through ``utils.weights.rnnlm_flax_to_state_dict``;
or what ``utils.weights.load_reference_checkpoint`` reads — a
``.pt``/``.ckpt`` state_dict file of the port's ``RNNCellStack`` or a
port checkpoints root.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.modules.rnn import RNNLM
from lasr_tpu_torch.utils.registry import BaseConfig
from lasr_tpu_torch.utils.ocdbt import load_tree
from lasr_tpu_torch.utils.weights import (load_model_weights,
                                          load_reference_checkpoint,
                                          orbax_item, orbax_variables,
                                          read_orbax,
                                          rnnlm_flax_to_state_dict)


def load_lm_state_dict(lm_path: str, typ: str = "lstm"):
    """The LM's state_dict from ``lm_path`` (see the module docstring);
    ``typ`` is the cell type of an orbax tree."""
    item = orbax_item(lm_path)
    if item is not None:
        params = load_tree(item)
    else:
        tree = read_orbax(lm_path, "last", avg=1)
        if tree is None:
            return load_reference_checkpoint(lm_path, "last", avg=1)
        params, _ = orbax_variables(tree)
    return rnnlm_flax_to_state_dict(params, typ)


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
    load_model_weights(module, load_lm_state_dict(lm_path, module.typ))
    return RNNLM(module), lm_rate
