"""Joint CTC/attention beam search, batched with fixed-shape state
(counterpart of ``lasr_tpu/decode/beam.py``).

The whole batch of beams advances one token per step:
  - hypothesis state is fixed-shape tensors (tokens [B,K,Lmax], scores
    [B,K], CTC prefix DP state r^n/r^b [B,K,T,2], per-layer decoder KV
    caches);
  - each step: one cached decoder call for all B·K hyps → top-``ctc_beam``
    attention candidates (blank excluded) → the CTC prefix recursion over
    the frames for all B·K·C candidates → joint rescoring
    ``(1-λ)·att + λ·Δctc`` → global top-K with eos-splitting into a
    fixed ended pool;
  - Hybrid CTC/attention end detection (Watanabe Eq. 50) per utterance
    from a best-score-by-length table.

``online=True`` is the reference's streaming decode (``ctc_att_online``):
the model's chunked encoder under the reference's length convention
(``ref_tail``), the online decoder step whose monotonic-attention
endpoints ride the cache per beam slot and chain across same-parent
siblings (``decoder_step_ep``), the attention prescreen over the full
vocabulary (blank included), truncated CTC scoring (each hypothesis
carries a frontier, the first frame at or after its parent's where no
candidate's prefix score improves; candidates are read there),
online end detection, and a final rescore of ended hypotheses whose
frontier stopped short of the utterance (``w·ctc_full + att``, the length
bonus dropped).

Shallow RNNLM fusion (``lm``, ``lm_weight``): one LM step over the B·K
hypotheses' last tokens each token step, its log-softmax (f32) at each
candidate added as ``lm_weight·lm`` to the attention part of the joint
score; the candidate prescreen stays attention-only, and the LM state is
reordered by parent with the KV cache.  ``nbest`` hypotheses come back
from the ended pool, best first.

The CTC prefix recursion is the sequential form (the JAX package's
default; its ``parallel_scan`` option is not ported).  The step index is
a host integer here, so the frames before the prefix length, which the
JAX scan masks, are simply not visited.

Ties: every top-k is a stable descending sort, so among equal scores the
lower index wins — the rule of ``lax.top_k``.  Entries at ``LOG_ZERO`` tie
often, and the order decides which hypotheses fill the pools.

Not ported yet: the incremental (mid-stream, resumable) online search
of ``IncrementalBeamSession``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.modules.rnn import select_state

LOG_ZERO = -1e10
D_END = -10.0
M_END = 3


@dataclass
class BeamHypotheses:
    """Host-side decode result for one batch."""
    tokens: np.ndarray   # (B, nbest, Lmax) incl. sos/eos, -1 padded
    lengths: np.ndarray  # (B, nbest)
    scores: np.ndarray   # (B, nbest)

    def best_ids(self, b: int, strip: bool = True) -> List[int]:
        n = int(self.lengths[b, 0])
        seq = self.tokens[b, 0, :n].tolist()
        return seq[1:-1] if strip else seq

    def nbest_ids(self, b: int, strip: bool = True):
        """[(token_ids, score)] for utterance ``b``, best first; empty
        pool entries (LOG_ZERO scores) are dropped."""
        out = []
        for k in range(self.tokens.shape[1]):
            n = int(self.lengths[b, k])
            if n <= 0 or self.scores[b, k] <= LOG_ZERO / 2:
                continue
            seq = self.tokens[b, k, :n].tolist()
            out.append((seq[1:-1] if strip else seq, float(self.scores[b, k])))
        return out


def _logaddexp(a, b):
    """log(e^a + e^b) with LOG_ZERO as an absorbing floor."""
    m = torch.maximum(a, b)
    out = torch.clamp(m, min=LOG_ZERO) + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(m <= LOG_ZERO, LOG_ZERO, out)


def _top_k(x, k: int):
    """Top-k along the last axis, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x, idx):
    """x: (B, N, ...); idx: (B, K) → (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _ctc_initial_state(lpz, blank: int):
    """(r^n, r^b) of the empty prefix: the cumulative blank path (B, T, 2)."""
    r_b = torch.cumsum(lpz[:, :, blank], dim=1)
    return torch.stack([torch.full_like(r_b, LOG_ZERO), r_b], dim=-1)


def _ctc_prefix_step(lpz, r_prev, last_tok, cand, out_len: int, blank: int,
                     want_psi_all: bool = False):
    """CTC prefix scores of every (B, K, C) candidate extension.

    lpz: (B, T, V) log-probs with frames past each utterance neutralized
    (blank free, labels impossible); r_prev: (B, K, T, 2); last_tok:
    (B, K); cand: (B, K, C); out_len: current prefix length.  Returns
    (psi (B, K, C), r_new (B, K, C, T, 2)), and with ``want_psi_all`` also
    psi_all (B, K, C, T), the prefix score after each frame (the truncated
    CTC frontier rule reads it)."""
    B, T, V = lpz.shape
    K, C = cand.shape[1:]
    xs = torch.gather(lpz.transpose(1, 2), 1,
                      cand.reshape(B, K * C, 1).expand(B, K * C, T)
                      ).reshape(B, K, C, T)
    r_sum = _logaddexp(r_prev[..., 0], r_prev[..., 1])          # (B, K, T)
    if out_len == 0:
        log_phi = r_sum[:, :, None, :].expand(B, K, C, T)
    else:
        same = cand == last_tok[:, :, None]
        log_phi = torch.where(same[..., None], r_prev[:, :, None, :, 1],
                              r_sum[:, :, None, :])
    blank_lp = lpz[:, :, blank]
    start = max(out_len, 1)
    rn = xs[..., 0] if out_len == 0 else torch.full_like(xs[..., 0], LOG_ZERO)
    rb = torch.full_like(rn, LOG_ZERO)
    psi = rn
    rn_seq, rb_seq, psi_seq = [rn] * start, [rb] * start, [psi] * start
    for t in range(start, T):
        phi, x = log_phi[..., t - 1], xs[..., t]
        rn, rb = (_logaddexp(rn, phi) + x,
                  _logaddexp(rn, rb) + blank_lp[:, t, None, None])
        psi = _logaddexp(psi, phi + x)
        rn_seq.append(rn)
        rb_seq.append(rb)
        psi_seq.append(psi)
    r_new = torch.stack([torch.stack(rn_seq, dim=-1),
                         torch.stack(rb_seq, dim=-1)], dim=-1)
    if want_psi_all:
        return psi, r_new, torch.stack(psi_seq, dim=-1)
    return psi, r_new


class CTCAttBeamDecoder:
    """Batched joint CTC/attention beam search over a model's decode hooks.

    Constructor parameters mirror the JAX ``CTCAttBeamDecoder`` (which
    mirrors the reference ``CTC_ATT_Decoder``); the model carries its own
    weights.  ``online=True`` needs a streaming model (``encode_online``,
    ``decoder_step_ep``).  ``lm`` is an ``RNNLM`` (or its
    ``RNNCellStack``) for shallow fusion at ``lm_weight``.
    ``device=None`` means CUDA (raises without a GPU); the model and the
    LM are moved there."""

    def __init__(self, model, sos: int = 1, eos: int = 2, beam: int = 10,
                 ctc_beam: int = 15, nbest: int = 1, ctc_weight: float = 0.5,
                 penalty: float = 0.0, lm_weight: float = 0.0, blank: int = 0,
                 maxlenratio: float = 0.0, minlenratio: float = 0.0,
                 online: bool = False, lm=None, device=None):
        if online and not hasattr(model, "encode_online"):
            raise ValueError(f"online decoding needs a streaming model; "
                             f"{type(model).__name__} has no encode_online")
        if lm_weight and lm is None:
            raise ValueError("lm_weight set but no lm provided")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        lm = getattr(lm, "module", lm)
        self.lm = None if lm is None else lm.to(self.device).eval()
        self.lm_weight = lm_weight if lm is not None else 0.0
        self.sos, self.eos, self.blank = sos, eos, blank
        self.beam, self.ctc_beam, self.nbest = beam, ctc_beam, nbest
        self.ctc_weight = ctc_weight
        self.penalty = penalty
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.online = online

    @torch.no_grad()
    def encode(self, feats, feat_len, pos_offset=0):
        """Decode-time encoder forward → (hs, hs_len, lpz): per-row solo
        lengths (``solo_pad``) offline, the reference decoder's length
        convention (``ref_tail``) online; the CTC log-probs are f32
        whatever the model's compute type.  ``pos_offset``: the offline
        encoder's absolute start position(s) (long-form windows)."""
        if self.online:
            hs, hs_len = self.model.encode_online(feats, feat_len,
                                                  ref_tail=True)
        else:
            hs, hs_len = self.model.encode(feats, feat_len, solo_pad=True,
                                           pos_offset=pos_offset)
        lpz = torch.log_softmax(self.model.ctc_logits(hs).float(), dim=-1)
        return hs, hs_len, lpz

    def max_len(self, T: int) -> int:
        return T if self.maxlenratio == 0.0 \
            else max(1, int(self.maxlenratio * T))

    @torch.no_grad()
    def __call__(self, feats, feat_len) -> BeamHypotheses:
        """feats: (B, T_in, D); feat_len: (B,).  Encoder + beam search."""
        feats = torch.as_tensor(feats).to(self.device)
        feat_len = torch.as_tensor(feat_len).to(self.device)
        hs, hs_len, lpz = self.encode(feats, feat_len)
        return self.search(hs, hs_len, lpz, self.max_len(hs.shape[1]))

    def _masked_lpz(self, lpz, hs_len):
        """Frames past hs_len: blank is free, labels impossible."""
        pad_t = (torch.arange(lpz.shape[1], device=lpz.device)[None, :]
                 >= hs_len[:, None])
        out = lpz.masked_fill(pad_t[:, :, None], LOG_ZERO)
        out[:, :, self.blank] = torch.where(pad_t, 0.0, lpz[:, :, self.blank])
        return out

    def _num_cand(self, V: int) -> int:
        if self.online:
            # the online prescreen spans the vocabulary, blank included
            return V if self.ctc_weight == 1.0 else min(self.ctc_beam, V)
        return min(self.ctc_beam, V - 1)

    @torch.no_grad()
    def search(self, hs, hs_len, lpz, max_len: int) -> BeamHypotheses:
        B, T, _ = hs.shape
        V = lpz.shape[-1]
        K = self.beam
        C = self._num_cand(V)
        E = 2 * K                        # ended pool size
        Lmax = max_len + 2               # sos + tokens + final free eos
        dev = hs.device
        rows = torch.arange(B, device=dev)[:, None]
        online, w = self.online, self.ctc_weight

        lpz = self._masked_lpz(lpz, hs_len)
        mem_k, mem_v = self.model.decoder_project_memory(hs)
        mem_k = mem_k.repeat_interleave(K, dim=1)
        mem_v = mem_v.repeat_interleave(K, dim=1)
        mem_mask = (torch.arange(T, device=dev)[None, :] < hs_len[:, None]
                    )[:, None, :].repeat_interleave(K, dim=0)

        tokens = torch.full((B, K, Lmax), -1, dtype=torch.long, device=dev)
        tokens[:, :, 0] = self.sos
        score = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                            LOG_ZERO)[None].expand(B, K).clone()
        ctc_prev = torch.zeros(B, K, device=dev)
        r = _ctc_initial_state(lpz, self.blank)[:, None].expand(B, K, T, 2)
        last_tok = torch.full((B, K), self.sos, dtype=torch.long, device=dev)
        alive = torch.zeros(B, K, dtype=torch.bool, device=dev)
        alive[:, 0] = True
        cache = self.model.decoder_init_cache(B * K, Lmax)
        ended_score = torch.full((B, E), LOG_ZERO, device=dev)
        ended_len = torch.zeros(B, E, dtype=torch.long, device=dev)
        ended_tok = torch.full((B, E, Lmax), -1, dtype=torch.long, device=dev)
        best_by_len = torch.full((B, Lmax + 2), LOG_ZERO, device=dev)
        row_done = torch.zeros(B, dtype=torch.bool, device=dev)
        row_maxlen = torch.clamp(hs_len, max=max_len)
        # ended hyps are kept only when len(yseq) > minlen
        row_minlen = (self.minlenratio * hs_len).to(torch.long)
        # online state: each hypothesis's CTC frontier (the initial state
        # covers one frame), its accumulated (1-w)·att score, the ended
        # pool's final-rescore inputs, and each hypothesis's previous beam
        # slot (the endpoint chain gathers by it)
        frontier = torch.ones(B, K, dtype=torch.long, device=dev)
        att_lm = torch.zeros(B, K, device=dev)
        ended_att_lm = torch.zeros(B, E, device=dev)
        ended_rescore = torch.zeros(B, E, device=dev)
        ended_need = torch.zeros(B, E, dtype=torch.bool, device=dev)
        parent_prev = torch.zeros(B, K, dtype=torch.long, device=dev)
        t_rng = torch.arange(1, T, device=dev)
        lm_state = None if self.lm is None else self.lm.zero_state(B * K)

        i = 0
        while i < max_len and not bool(row_done.all()):
            if online:
                logp, cache, _ = self.model.decoder_step_ep(
                    last_tok.reshape(B * K), i, cache, mem_k, mem_v,
                    mem_mask, parent_prev, alive)
            else:
                logp, cache = self.model.decoder_step(
                    last_tok.reshape(B * K), i, cache, mem_k, mem_v,
                    mem_mask)
            att_logp = logp.reshape(B, K, V).float()
            if self.lm is not None:
                lm_state, lm_logits = self.lm(lm_state,
                                              last_tok.reshape(B * K))
                lm_logp = torch.log_softmax(lm_logits.float(), dim=-1
                                            ).reshape(B, K, V)
            if online:
                cand_att, cand_ids = _top_k(att_logp, C)
            else:
                # the offline prescreen excludes the blank row
                att_nb = att_logp.clone()
                att_nb[:, :, self.blank] = LOG_ZERO
                cand_att, cand_ids = _top_k(att_nb, C)           # (B, K, C)

            out = _ctc_prefix_step(lpz, r, last_tok, cand_ids, i,
                                   self.blank, want_psi_all=online)
            psi, r_cand = out[:2]
            r_sum = _logaddexp(r[..., 0], r[..., 1])             # (B, K, T)
            if online:
                # frontier: the first frame t >= the parent's frontier where
                # no candidate's prefix score improves; frames past hs_len
                # stall by construction
                psi_all = out[2]
                stall = ~(psi_all[..., 1:] - psi_all[..., :-1] > 0.0).any(
                    dim=2) | (t_rng >= hs_len[:, None, None])
                valid = stall & (t_rng >= frontier[..., None])   # (B,K,T-1)
                end = torch.where(valid.any(dim=-1),
                                  valid.to(torch.uint8).argmax(dim=-1) + 1, T)
                # candidates are read at the frontier; eos scores the
                # prefix's complete-sequence probability there
                psi = torch.gather(psi_all, 3, (end - 1)[..., None, None]
                                   .expand(B, K, C, 1))[..., 0]
                eos_score = torch.gather(
                    r_sum, 2, torch.clamp(end, max=T - 1)[..., None])[..., 0]
            else:
                eos_score = r_sum[..., -1]
            # eos scores the prefix's complete-sequence CTC probability
            psi = torch.where(cand_ids == self.eos, eos_score[..., None], psi)

            # the attention (+LM) part of the joint score; the online
            # enders keep it as their att_lm score
            cand_attlm = (1.0 - w) * cand_att
            if self.lm is not None:
                cand_attlm = cand_attlm + self.lm_weight * torch.gather(
                    lm_logp, 2, cand_ids)
            joint = cand_attlm + w * (psi - ctc_prev[..., None])
            total = torch.where(alive[..., None], score[..., None] + joint,
                                LOG_ZERO)
            top_score, top_idx = _top_k(total.reshape(B, K * C), K)
            parent = torch.div(top_idx, C, rounding_mode="floor")
            sel_tok = torch.gather(cand_ids.reshape(B, K * C), 1, top_idx)

            new_tokens = _gather_rows(tokens, parent)
            new_tokens[:, :, i + 1] = sel_tok
            new_ctc_prev = torch.gather(psi.reshape(B, K * C), 1, top_idx)
            new_r = _gather_rows(r_cand.reshape(B, K * C, T, 2), top_idx)
            ok = (torch.gather(alive, 1, parent)
                  & (top_score > LOG_ZERO / 2) & ~row_done[:, None])
            if online:
                # children inherit the parent's frontier; att_lm
                # accumulates the attention part of each selected token
                frontier = torch.gather(end, 1, parent)
                att_lm = torch.gather(att_lm, 1, parent) + torch.gather(
                    cand_attlm.reshape(B, K * C), 1, top_idx)

            hyp_len = i + 2                   # len(yseq) incl. sos + token
            is_eos = ((sel_tok == self.eos) & ok
                      & (hyp_len > row_minlen[:, None]))
            bonus = float(i + 1) * self.penalty
            survive = ok & ~is_eos
            final_step = (i == row_maxlen - 1)[:, None]
            # final-step free eos appended to the survivors
            forced = survive & final_step
            new_tokens[:, :, i + 2] = torch.where(forced, self.eos,
                                                  new_tokens[:, :, i + 2])

            # pool insertion: natural enders at len i+2, forced at i+3
            nat_score = torch.where(is_eos, top_score + bonus, LOG_ZERO)
            frc_score = torch.where(forced, top_score + bonus, LOG_ZERO)
            pool_score = torch.cat([ended_score, nat_score, frc_score], 1)
            pool_len = torch.cat(
                [ended_len,
                 torch.full((B, K), hyp_len, dtype=torch.long, device=dev),
                 torch.full((B, K), hyp_len + 1, dtype=torch.long,
                            device=dev)], 1)
            pool_tok = torch.cat([ended_tok, new_tokens, new_tokens], 1)
            ended_score, keep_idx = _top_k(pool_score, E)
            ended_len = torch.gather(pool_len, 1, keep_idx)
            ended_tok = _gather_rows(pool_tok, keep_idx)
            if online:
                # rescore inputs of enders whose frontier stopped short of
                # hs_len: the full-length complete-sequence CTC probability
                # of the parent prefix (natural eos) or the child (forced)
                need = frontier < hs_len[:, None]
                pool = (torch.cat([ended_att_lm, att_lm, att_lm], 1),
                        torch.cat([ended_rescore,
                                   torch.gather(r_sum[..., -1], 1, parent),
                                   _logaddexp(new_r[..., -1, 0],
                                              new_r[..., -1, 1])], 1),
                        torch.cat([ended_need, need & is_eos,
                                   need & forced], 1))
                ended_att_lm, ended_rescore, ended_need = (
                    torch.gather(x, 1, keep_idx) for x in pool)

            best_by_len[:, hyp_len] = torch.maximum(
                best_by_len[:, hyp_len], nat_score.max(dim=1).values)
            best_by_len[:, hyp_len + 1] = torch.maximum(
                best_by_len[:, hyp_len + 1], frc_score.max(dim=1).values)

            new_alive = survive & ~final_step
            # the online endpoints stay per beam slot (the next step's
            # chain gathers them by parent)
            flat_parent = (parent + rows * K).reshape(-1)
            cache = {k: v if k == "ep" else v.index_select(1, flat_parent)
                     for k, v in cache.items()}
            if self.lm is not None:
                lm_state = select_state(lm_state, flat_parent)

            if online:
                # every live hypothesis's frontier reached hs_len, and the
                # longest ended length scores D_end below the best ended
                # hypothesis at each of the M previous lengths
                long_val = best_by_len[:, i + 2]
                end_detected = torch.where(
                    new_alive, frontier == hs_len[:, None], True
                ).all(dim=1) & (long_val > LOG_ZERO / 2)
                for m in range(M_END):
                    val = best_by_len[:, max(i + 1 - m, 0)]
                    end_detected = end_detected & (i + 1 - m >= 0) \
                        & (val > LOG_ZERO / 2) & (long_val - val < D_END)
            else:
                # Watanabe Eq. 50: M consecutive lengths below the best by
                # D_end
                best_overall = ended_score.max(dim=1).values
                end_detected = best_overall > LOG_ZERO / 2
                for m in range(M_END):
                    val = best_by_len[:, max(i - m, 0)]
                    end_detected = end_detected & (i - m >= 0) \
                        & (val > LOG_ZERO / 2) & (val - best_overall < D_END)
            if self.maxlenratio != 0.0:
                end_detected = torch.zeros_like(end_detected)
            row_done = (row_done | end_detected | ~new_alive.any(dim=1)
                        | (i + 1 >= row_maxlen))

            tokens, score, ctc_prev, r = (
                new_tokens, torch.where(new_alive, top_score, LOG_ZERO),
                new_ctc_prev, new_r)
            last_tok, alive, parent_prev = sel_tok, new_alive, parent
            i += 1

        if online:
            # truncated enders: w·ctc_full + att score, replacing the
            # stored score (the length bonus is dropped, as the reference
            # does)
            ended_score = torch.where(ended_need,
                                      w * ended_rescore + ended_att_lm,
                                      ended_score)
        nb = min(self.nbest, E)
        top_score, top_idx = _top_k(ended_score, nb)
        return BeamHypotheses(
            tokens=_gather_rows(ended_tok, top_idx).cpu().numpy(),
            lengths=torch.gather(ended_len, 1, top_idx).cpu().numpy(),
            scores=top_score.cpu().numpy())
