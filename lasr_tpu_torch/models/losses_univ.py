"""The dual-view training criterion of the Univ model (counterpart of
``lasr_tpu/models/losses_univ.py``):

  - ``KL_Loss``: KL(student log-softmax ‖ teacher softmax), the teacher
    detached, masked, divided by the batch (or the unmasked count);
  - ``ctc_force_align``: the Viterbi CTC forced alignment (max-semiring
    forward over the extended label lattice, a loop over frames, and the
    backtrace) → each label's emission frame, 1-indexed;
  - ``Align_Loss``: supervision of the decoder's source-attention maps,
    modes ``mid`` / ``beg`` / ``end`` (the expected attended frame's
    squared distance to a label frame), ``ctc`` (to the forced
    alignment's frame), ``norm`` / ``qua`` (attention mass per token)
    and ``google`` (mass outside a window around each label);
  - ``CTC_CE_Univ_Loss``: label-smoothed attention and CTC losses on both
    views, KL(online ‖ offline) on the attention and CTC outputs, and the
    alignment loss.

Built on ``E2E_Loss``: rows with ``hs_len == 0`` (bucket padding) count
for nothing, and under a process group every denominator is the global
batch's (``parallel.dist.global_sum``), so the ranks' losses and
gradients sum to the global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from lasr_tpu_torch.models.losses import E2E_Loss, att_accuracy
from lasr_tpu_torch.ops.ctc import ctc_labels_from_padded
from lasr_tpu_torch.parallel.dist import global_sum

_NEG_INF = -1e30


def _global_count(n) -> torch.Tensor:
    return torch.clamp(global_sum(n), min=1)


class KL_Loss:
    def __init__(self, size: int, normalize_length: bool = False):
        self.size = size
        self.normalize_length = normalize_length

    def __call__(self, x, y, mask, rows: Optional[torch.Tensor] = None):
        """x: student logits (..., V); y: teacher logits (same shape);
        mask: True at EXCLUDED positions (broadcastable to x's leading
        axes); ``rows``: the batch count of the denominator (default the
        batch size)."""
        x = x.float()
        logp = torch.log_softmax(x, dim=-1)
        t = torch.softmax(y.detach().float(), dim=-1)
        kl = t * (torch.log(torch.clamp(t, min=1e-30)) - logp)
        kl = torch.where(mask[..., None], 0.0, kl)
        if self.normalize_length:
            denom = (~mask).sum()
        else:
            denom = rows if rows is not None else torch.tensor(
                x.shape[0], device=x.device)
        return kl.sum() / _global_count(denom)


def ctc_force_align(log_probs, labels, input_len, label_len,
                    blank: int = 0) -> torch.Tensor:
    """log_probs (B, T, V); labels (B, L) left-compacted; input_len /
    label_len (B,).  Returns (B, L) float32: label l's emission frame
    (1-indexed) on the Viterbi path, 0 where unused."""
    B, T, _ = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    s_idx = torch.arange(S, device=dev)
    is_lbl = (s_idx % 2) == 1
    lbl_pos = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                          0, L - 1)
    ext = torch.where(is_lbl[None, :],
                      labels.long()[:, lbl_pos], blank)              # (B, S)
    ext_m2 = torch.cat([ext.new_full((B, 2), blank), ext[:, :-2]], dim=1)
    can_skip = is_lbl[None, :] & (ext != ext_m2) & (s_idx[None, :] >= 2)
    n_states = 2 * label_len.long() + 1
    lp0 = log_probs[:, 0]
    alpha = torch.full((B, S), _NEG_INF, device=dev)
    alpha[:, 0] = torch.gather(lp0, 1, ext[:, :1])[:, 0]
    alpha[:, 1] = torch.where(label_len > 0,
                              torch.gather(lp0, 1, ext[:, 1:2])[:, 0],
                              _NEG_INF)
    floor = alpha.new_full((B, 2), _NEG_INF)
    live = s_idx[None, :] < n_states[:, None]
    ptrs = []
    for t in range(1, T):
        padded = torch.cat([floor, alpha], dim=1)
        stacked = torch.stack(
            [alpha, padded[:, 1:S + 1],
             torch.where(can_skip, padded[:, :S], _NEG_INF)], dim=-1)
        val = stacked.max(dim=-1).values
        best = stacked.argmax(dim=-1)         # the first of ties
        ok = (t < input_len)[:, None] & live
        alpha = torch.where(ok, val + torch.gather(log_probs[:, t], 1, ext),
                            alpha)
        ptrs.append(torch.where(ok, s_idx[None, :] - best, s_idx[None, :]))

    end1 = 2 * label_len.long()
    end2 = torch.clamp(end1 - 1, min=0)
    a1 = torch.gather(alpha, 1, end1[:, None])[:, 0]
    a2 = torch.gather(alpha, 1, end2[:, None])[:, 0]
    state = torch.where(a1 > a2, end1, end2)
    # backtrace from the last frame (frames past input_len point to
    # themselves)
    states = [state]
    for t in range(T - 1, 0, -1):
        state = torch.gather(ptrs[t - 1], 1, state[:, None])[:, 0]
        states.append(state)
    st = torch.stack(states[::-1])                                  # (T, B)
    # a label's emission frame: the first frame its state is entered (a
    # Viterbi path enters each label state once)
    prev = torch.cat([st.new_full((1, B), -1), st[:-1]])
    tt = torch.arange(T, device=dev)[:, None]
    newly = (st != prev) & (st % 2 == 1) & (tt < input_len[None, :])
    slot = torch.where(newly, torch.div(st - 1, 2, rounding_mode="floor"), L)
    align = torch.zeros(B, L + 1, device=dev)
    align.scatter_add_(1, slot.T, (tt + 1).float().T.expand(B, T).clone())
    return align[:, :L]


class Align_Loss:
    def __init__(self, ali_type: str = "mid", ignore_id: int = -1,
                 exp_dist: int = 3):
        if ali_type not in ("mid", "beg", "end", "ctc", "norm", "qua",
                            "google"):
            raise ValueError(f"unknown ali_type {ali_type!r}")
        self.ali_type = ali_type
        self.ignore_id = ignore_id
        self.exp_dist = exp_dist

    def __call__(self, ali_out, ali_beg=None, ali_end=None, enc_pad=None,
                 ctc_out=None, ctc_label=None, ctc_len=None):
        """ali_out: (B, layers·H, L+1, T) attention maps; ali_beg / ali_end:
        (B, L) label frames (ignore_id padded); enc_pad: (B, T) True at
        padded frames (a row padded throughout counts for nothing);
        ctc_out / ctc_label / ctc_len: the ``ctc`` mode's CTC logits,
        labels and lengths."""
        ali_out = ali_out.float()
        B, layers, olen, T = ali_out.shape
        dev = ali_out.device
        row_ok = torch.ones(B, dtype=torch.bool, device=dev) \
            if enc_pad is None else ~enc_pad.all(dim=1)

        if self.ali_type in ("mid", "beg", "end", "ctc"):
            pos = torch.arange(1, T + 1, dtype=torch.float32, device=dev)
            expect = torch.einsum("blot,t->blo", ali_out, pos)[:, :, :-1]
            if self.ali_type == "ctc":
                lpz = torch.log_softmax(ctc_out.float(), dim=-1)
                labels, label_len = ctc_labels_from_padded(ctc_label,
                                                           self.ignore_id)
                ali = ctc_force_align(lpz, labels, ctc_len, label_len)
                ylens = label_len
            else:
                ylens = (ali_beg != self.ignore_id).sum(dim=1)
                beg = ali_beg.float()
                end = (ali_end if ali_end is not None else ali_beg).float()
                ali = {"mid": (beg + end) / 2, "beg": beg,
                       "end": end}[self.ali_type]
            Lq = expect.shape[-1]
            valid = (torch.arange(Lq, device=dev)[None, :] < ylens[:, None]) \
                & row_ok[:, None]
            lat = torch.where(valid[:, None, :],
                              expect - ali[:, None, :Lq], 0.0)
            return (lat ** 2).sum() / (_global_count(valid.sum()) * layers) \
                / T

        if self.ali_type in ("qua", "norm"):
            ylens = torch.where(row_ok,
                                (ali_beg != self.ignore_id).sum(dim=1) + 1, 0)
            valid = torch.arange(olen, device=dev)[None, :] < ylens[:, None]
            masked = torch.where(valid[:, None, :, None], ali_out, 0.0)
            if self.ali_type == "qua":
                return (ylens[:, None].float() - masked.sum(dim=(2, 3))
                        ).sum() / (_global_count(row_ok.sum()) * layers)
            return torch.where(valid[:, None, :], 1.0 - masked.sum(dim=3),
                               0.0).sum() / (layers
                                             * _global_count(ylens.sum()))

        # google: the mass outside a window of exp_dist frames around
        # each label, the eos row's window from the last label's start on
        ylens = (ali_beg != self.ignore_id).sum(dim=1)
        beg = torch.clamp(ali_beg - self.exp_dist - 1, 0, T)
        end = torch.clamp(ali_end + self.exp_dist, 0, T)
        t_idx = torch.arange(T, device=dev)
        win = (t_idx[None, None, :] >= beg[:, :, None]) \
            & (t_idx[None, None, :] < end[:, :, None])               # (B,L,T)
        last_beg = torch.gather(beg, 1, torch.clamp(ylens - 1, min=0)[:, None])
        eos_win = t_idx[None, :] >= last_beg                          # (B, T)
        align = torch.cat([win[:, : olen - 1], eos_win[:, None, :]], dim=1)
        rows = torch.arange(olen, device=dev)[None, :] <= ylens[:, None]
        pad = enc_pad if enc_pad is not None else torch.zeros(
            B, T, dtype=torch.bool, device=dev)
        mask_ok = rows[:, :, None] & ~pad[:, None, :]
        loss = torch.where(mask_ok[:, None], ali_out * (1.0 - align[:, None]
                                                        .float()), 0.0)
        return loss.sum() / _global_count(mask_ok.sum()) / layers


class CTC_CE_Univ_Loss(E2E_Loss):
    """``(1-rate)·(att_on + att_off) + rate·(ctc_on + ctc_off) +
    ali_rate·ali + kl_rate·(KL_att + KL_ctc)`` (dict contract); the
    alignment loss runs when the batch carries label frames (``y_beg``)
    or ``ali_type`` is ``ctc``, else it is 0."""

    def __init__(self, size: int, padding_idx: int = -1,
                 smoothing: float = 0.1, rate: float = 0.5,
                 kl_rate: float = 1.0, ali_rate: float = 1.0,
                 ali_type: str = "mid"):
        super().__init__(size, padding_idx, smoothing, rate,
                         log_ctc_cer=False)
        self.kl_rate = kl_rate
        self.ali_rate = ali_rate
        self.kl = KL_Loss(size)
        self.ali = Align_Loss(ali_type, padding_idx)
        self.padding_idx = padding_idx

    def forward_univ(self, att_on, ctc_on, ali_out, att_off, ctc_off,
                     att_label, ctc_label, hs_len, label_beg=None,
                     label_end=None):
        """(main, att_on loss, ctc_on loss, alignment loss, KL)."""
        utt_valid = hs_len > 0
        rows = utt_valid.sum()
        n_valid = _global_count(rows)
        att_loss = self.att_loss(att_on.float(), att_label, utt_valid)
        att_loss_off = self.att_loss(att_off.float(), att_label, utt_valid)
        kl = self.kl(att_on, att_off, (att_label == self.padding_idx)
                     | ~utt_valid[:, None], rows)
        ctc_l = self.ctc_loss(ctc_on, ctc_label, hs_len, utt_valid, n_valid)
        ctc_l_off = self.ctc_loss(ctc_off, ctc_label, hs_len, utt_valid,
                                  n_valid)
        enc_pad = torch.arange(ctc_on.shape[1], device=hs_len.device
                               )[None, :] >= hs_len[:, None]
        kl = kl + self.kl(ctc_on, ctc_off, enc_pad, rows)
        if label_beg is not None or self.ali.ali_type == "ctc":
            ali_l = self.ali(ali_out, label_beg, label_end, enc_pad, ctc_off,
                             ctc_label, hs_len)
        else:
            ali_l = torch.zeros((), device=hs_len.device)
        main = ((1 - self.rate) * (att_loss + att_loss_off)
                + self.rate * (ctc_l + ctc_l_off)
                + self.ali_rate * ali_l + self.kl_rate * kl)
        return main, att_loss, ctc_l, ali_l, kl

    def train_forward(self, input_dict: Dict) -> Dict:
        main, att_l, ctc_l, ali_l, kl_l = self.forward_univ(
            att_on=input_dict["att_out_on"], ctc_on=input_dict["ctc_out_on"],
            ali_out=input_dict["ali_out"], att_off=input_dict["att_out_off"],
            ctc_off=input_dict["ctc_out_off"],
            att_label=input_dict["att_label"],
            ctc_label=input_dict["ctc_label"], hs_len=input_dict["hs_len"],
            label_beg=input_dict.get("y_beg"),
            label_end=input_dict.get("y_end"))
        return {"loss_main": main, "att_loss": att_l, "ctc_loss": ctc_l,
                "ali_loss": ali_l, "kl_loss": kl_l,
                "att_corr_on": att_accuracy(input_dict["att_out_on"],
                                            input_dict["att_label"],
                                            self.ignore_id),
                "att_corr_off": att_accuracy(input_dict["att_out_off"],
                                             input_dict["att_label"],
                                             self.ignore_id)}

    valid_forward = train_forward
