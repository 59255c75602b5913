"""Greedy CTC decoding (counterpart of ``lasr_tpu/decode/greedy.py``)."""

from __future__ import annotations

from typing import List, Sequence

import torch


def greedy_ctc_tokens(pred: Sequence[int], blank: int = 0) -> List[int]:
    """Collapse repeats, then drop blanks."""
    out, prev = [], None
    for p in pred:
        if p != prev and p != blank:
            out.append(int(p))
        prev = p
    return out


def ctc_greedy_decode(ctc_logits: torch.Tensor, hs_len: torch.Tensor,
                      blank: int = 0) -> List[List[int]]:
    """ctc_logits: (B, T, V); hs_len: (B,).  Per-utterance token ids."""
    pred = ctc_logits.argmax(dim=-1).cpu().tolist()
    lens = hs_len.cpu().tolist()
    return [greedy_ctc_tokens(pred[i][: int(lens[i])], blank=blank)
            for i in range(len(pred))]
