"""Training criteria (counterpart of ``lasr_tpu/models/losses.py``).

  - ``LabelSmoothingLoss``: KL divergence to a smoothed one-hot, padding
    masked, divided by the batch (or by the valid rows, or the token
    count with ``normalize_length``).
  - ``E2E_Loss``: ``rate·ctc + (1-rate)·att`` with the attention accuracy
    and the greedy-CTC CER; the CTC term divides by the rows with
    ``hs_len > 0``, so bucket-padding rows count for nothing.
  - ``ctc_greedy_cer_device`` (a vectorized Levenshtein over frames, on
    the device) and ``ctc_greedy_cer`` (host, numpy).

Criteria are plain callables with the reference's dict-in / dict-out
contract.

Under a process group of several ranks every denominator (valid rows,
tokens, reference lengths) is the global batch's count, summed over the
ranks outside autograd, and each numerator stays the rank's own: the sum
of the ranks' losses and metrics is the global batch's, as ``lasr_tpu``'s
one program on a data axis computes it, and the sum of their gradients
is its gradient.
"""

from __future__ import annotations

from itertools import groupby
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lasr_tpu_torch.ops.ctc import (ctc_forward_from_logits,
                                    ctc_labels_from_padded)
from lasr_tpu_torch.parallel.dist import global_sum
from lasr_tpu_torch.utils.text import edit_distance


class LabelSmoothingLoss:
    def __init__(self, size: int, padding_idx: int = -1,
                 smoothing: float = 0.1, normalize_length: bool = False):
        self.size = size
        self.padding_idx = padding_idx
        self.confidence = 1.0 - smoothing
        self.smoothing = smoothing
        self.normalize_length = normalize_length

    def __call__(self, x: torch.Tensor, target: torch.Tensor,
                 utt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, L, V) logits; target: (B, L) ids padded with
        padding_idx; ``utt_valid`` (B,) bool drops whole rows and makes
        the denominator the count of valid rows."""
        B, V = x.shape[0], self.size
        logp = torch.log_softmax(x, dim=-1)
        ignore = target == self.padding_idx
        if utt_valid is not None:
            ignore = ignore | ~utt_valid[:, None]
        tgt = torch.where(ignore, 0, target).long()
        true_dist = torch.where(F.one_hot(tgt, V).bool(), self.confidence,
                                self.smoothing / (V - 1))
        # torch KLDivLoss(log_input, target) = target * (log target - input)
        kl = true_dist * (torch.log(torch.clamp(true_dist, min=1e-30)) - logp)
        kl = torch.where(ignore[..., None], 0.0, kl)
        if self.normalize_length:
            denom = (~ignore).sum()
        elif utt_valid is not None:
            denom = utt_valid.sum()
        else:
            denom = torch.tensor(B, device=x.device)
        return kl.sum() / torch.clamp(global_sum(denom), min=1)


def att_accuracy(att_out: torch.Tensor, att_label: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Token accuracy over the non-ignored positions."""
    ok = (att_out.argmax(dim=-1) == att_label) & (att_label != ignore_id)
    return ok.sum() / torch.clamp(global_sum((att_label != ignore_id).sum()),
                                  min=1)


class E2E_Loss:
    """Joint CTC + label-smoothed attention loss (dict contract)."""

    def __init__(self, size: int, padding_idx: int = -1,
                 smoothing: float = 0.1, rate: float = 0.5,
                 ctc_type: str = "builtin", ignore_id: int = -1,
                 blank_id: int = 0, log_ctc_cer: bool = True):
        del ctc_type  # one first-party implementation covers both
        self.att_loss = LabelSmoothingLoss(size, padding_idx, smoothing,
                                           False)
        self.rate = rate
        self.ignore_id = ignore_id
        self.blank_id = blank_id
        self.log_ctc_cer = log_ctc_cer
        # the greedy CER runs on the steps whose metrics are logged: with
        # a "step" in the dict and an interval > 1, other steps report -1
        # (the Trainer sets the interval from its log_interval)
        self.ctc_cer_interval = None

    def __call__(self, att_out, ctc_out, att_label, ctc_label, hs_len):
        att_out = att_out.float()
        utt_valid = hs_len > 0   # bucket-padding rows have hs_len == 0
        n_valid = torch.clamp(global_sum(utt_valid.sum()), min=1)
        att = self.att_loss(att_out, att_label, utt_valid)
        ctc = self.ctc_loss(ctc_out, ctc_label, hs_len, utt_valid, n_valid)
        main = (1.0 - self.rate) * att + self.rate * ctc
        return main, att, ctc

    def ctc_loss(self, ctc_out, ctc_label, hs_len, utt_valid, n_valid):
        """The CTC loss summed over the valid rows / their global count."""
        labels, label_len = ctc_labels_from_padded(ctc_label, self.ignore_id)
        ll = ctc_forward_from_logits(ctc_out, hs_len, labels, label_len,
                                     blank=self.blank_id)
        return -torch.where(utt_valid, ll, 0.0).sum() / n_valid

    def train_forward(self, input_dict: Dict) -> Dict:
        main, att, ctc = self(
            att_out=input_dict["att_out"], ctc_out=input_dict["ctc_out"],
            att_label=input_dict["att_label"],
            ctc_label=input_dict["ctc_label"], hs_len=input_dict["hs_len"])
        out = {"loss_main": main, "att_loss": att, "ctc_loss": ctc,
               "att_corr": att_accuracy(input_dict["att_out"],
                                        input_dict["att_label"],
                                        self.ignore_id)}
        if self.log_ctc_cer:
            if self.logs_step(input_dict.get("step")):
                with torch.no_grad():
                    out["ctc_cer"] = ctc_greedy_cer_device(
                        input_dict["ctc_out"], input_dict["ctc_label"],
                        input_dict["hs_len"], self.blank_id, self.ignore_id)
            else:
                out["ctc_cer"] = torch.tensor(-1.0,
                                              device=main.device)
        return out

    def logs_step(self, step: Optional[int]) -> bool:
        """Whether the train call at ``step`` (the step before its update;
        None: outside the Trainer's steps) computes its metrics in full:
        every ``ctc_cer_interval``-th call, the ones whose metrics are
        logged."""
        interval = self.ctc_cer_interval or 1
        return step is None or interval <= 1 or (int(step) + 1) % interval == 0

    valid_forward = train_forward


def ctc_greedy_cer_device(ctc_out, ctc_label, hs_len, blank_id: int = 0,
                          ignore_id: int = -1) -> torch.Tensor:
    """Greedy-CTC CER on the device: argmax, collapse of repeats and
    blanks, and a Levenshtein DP row per frame with the insertion
    recurrence resolved as ``newD[j] = j + cummin_{i<=j}(E[i] - i)``;
    frames that emit nothing leave the row as it is.  Returns sum(edit
    errors) / sum(reference lengths) over rows with a non-empty
    reference (0 when none)."""
    B, T, _ = ctc_out.shape
    dev = ctc_out.device
    pred = ctc_out.argmax(dim=-1).to(torch.int32)
    prev = torch.cat([torch.full((B, 1), -12345, dtype=torch.int32,
                                 device=dev), pred[:, :-1]], dim=1)
    emit = ((torch.arange(T, device=dev)[None, :] < hs_len[:, None])
            & (pred != blank_id) & (pred != prev))
    valid = (ctc_label != blank_id) & (ctc_label != ignore_id)
    L = ctc_label.shape[1]
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    ref = ctc_label.gather(1, order).to(torch.int32)
    ref_len = valid.sum(dim=1).to(torch.int32)
    ref = torch.where(torch.arange(L, device=dev)[None, :] < ref_len[:, None],
                      ref, -7)
    cols = torch.arange(L + 1, dtype=torch.int32, device=dev)[None, :]
    D = cols.expand(B, L + 1).clone()
    for t in range(T):
        c = pred[:, t, None]
        sub = D[:, :-1] + (c != ref).to(torch.int32)
        E = torch.cat([D[:, :1] + 1, torch.minimum(D[:, 1:] + 1, sub)], dim=1)
        newD = cols + torch.cummin(E - cols, dim=1).values
        D = torch.where(emit[:, t, None], newD, D)
    dist = D.gather(1, ref_len[:, None].long())[:, 0]
    has = ref_len > 0
    errs = torch.where(has, dist, 0).sum()
    total = torch.where(has, ref_len, 0).sum()
    return errs.float() / torch.clamp(global_sum(total), min=1).float()


def ctc_greedy_cer(ctc_out: np.ndarray, ctc_label: np.ndarray,
                   hs_len: np.ndarray, blank_id: int = 0,
                   ignore_id: int = -1) -> float:
    """Host-side greedy-CTC CER (numpy inputs)."""
    pred = np.argmax(ctc_out, axis=-1)
    errs, total = 0, 0
    for i in range(pred.shape[0]):
        hyp = [k for k, _ in groupby(pred[i, : int(hs_len[i])])
               if k != blank_id and k != ignore_id]
        ref = [int(t) for t in ctc_label[i]
               if t != blank_id and t != ignore_id]
        if ref:
            errs += edit_distance(ref, hyp)
            total += len(ref)
    return errs / total if total else 0.0
